"""align_us: device us a batch of the traceback alone (the winner's
corridor fetch K2, its query's strand select, K4), from the program's inner marks ``align``
over the second traced window (``ngmb/program_window.py``).  The marks
sum on a chain of their own, apart from the five phases, so ``finish_us``
reads as before them.  None where the program has no such marks."""

from ngmb import program_window


def read(ctx):
    pt = program_window.of(ctx)
    if pt is None:
        return None
    marks = pt["marks"].get("inner_marks", {}).get("align", 0)
    return pt["marks"]["inner_ns"]["align"] / marks / 1e3 if marks else None
