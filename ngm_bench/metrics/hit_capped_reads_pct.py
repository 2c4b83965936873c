"""hit_capped_reads_pct: 100 x the reads whose index hits passed candidate
search's per-read cap H (the program's counter ``reads_hit_capped``, K6's
own count) over the reads of the second traced window
(``ngmb/program_window.py``).  None where the program has no such
counter."""

from ngmb import program_window


def read(ctx):
    pt = program_window.of(ctx)
    if pt is None or not pt["reads"] or "reads_hit_capped" not in pt["marks"]:
        return None
    return 100.0 * pt["marks"]["reads_hit_capped"] / pt["reads"]
