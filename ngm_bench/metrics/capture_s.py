"""capture_s: seconds of the cell's entries in ``StepGraphs.captures``
(each one eager warm-up step plus the capture), all made in set-up."""


def read(ctx):
    caps = ctx["captures"]
    return sum(c["seconds"] for c in caps) if caps else None
