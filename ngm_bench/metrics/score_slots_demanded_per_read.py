"""score_slots_demanded_per_read: the slots the score pass (K1) was asked
for before its slot cap, from the program's counter
``score_slots_demanded``, over the reads of the second traced window
(``ngmb/program_window.py``)."""

from ngmb import program_window


def read(ctx):
    pt = program_window.of(ctx)
    if pt is None or not pt["reads"]:
        return None
    return pt["marks"]["score_slots_demanded"] / pt["reads"]
