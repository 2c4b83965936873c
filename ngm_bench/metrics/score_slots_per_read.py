"""score_slots_per_read: the real slots the score pass (K1) must score,
over the reads of the traced window: the candidates of each read with two
or more (paired: of both mates where either has two or more), capped at
the batch's slot cap, counted from the outputs' n_candidates."""


def read(ctx):
    return ctx["counters"]["score_slots"] / ctx["reads"] if ctx["reads"] else None
