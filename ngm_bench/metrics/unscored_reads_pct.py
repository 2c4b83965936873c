"""unscored_reads_pct: 100 x the reads the score pass's slot cap left
wholly or partly unscored (the program's counter ``reads_unscored``) over
the reads of the second traced window (``ngmb/program_window.py``)."""

from ngmb import program_window


def read(ctx):
    pt = program_window.of(ctx)
    if pt is None or not pt["reads"]:
        return None
    return 100.0 * pt["marks"]["reads_unscored"] / pt["reads"]
