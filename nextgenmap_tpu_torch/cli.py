"""``ngm-torch``: the PyTorch port's command line.

Uses the reference's parser and config mapping
(``nextgenmap_tpu.cli.build_parser`` / ``config_from_args``) and adds
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).  Flags
outside the ported slice raise NotImplementedError naming the ROADMAP item
that will bring them.

    python -m nextgenmap_tpu_torch.cli map -r ref.fa -q reads.fq -o out.sam
    python -m nextgenmap_tpu_torch.cli map -r ref.fa -1 r1.fq -2 r2.fq -o pe.sam
    python -m nextgenmap_tpu_torch.cli map -r ref.fa -q reads.fq -n 2 -o top2.sam

Modes, with every one of the above: ``--end-to-end`` (glocal alignment, no
clipping), ``--bs-mapping [--bs-cutoff N]`` (bisulfite: CT/GA-collapsed
tables and conversion-tolerant scoring), ``--slam-seq 1|2``.  Reads up to
1000 bp map with the default batch shrunk as the read length grows.
"""

from __future__ import annotations

import shlex
import sys

from nextgenmap_tpu.cli import build_parser, config_from_args
from nextgenmap_tpu_torch.models.mapper import check_slice

# (argument attribute, is set?, what) for flags the slice does not run yet
_UNPORTED = (
    ("bam", lambda v: v, "--bam output waits for ROADMAP A12"),
    ("resume", lambda v: v, "--resume waits for ROADMAP A12"),
    ("profile", lambda v: v, "--profile (a jax.profiler trace) has no port yet"),
    ("dist_nprocs", lambda v: v != 1, "--dist-nprocs waits for ROADMAP A14"),
    ("shard_across_hosts", lambda v: v,
     "--shard-across-hosts waits for ROADMAP A14"),
)


def _parser():
    parser, map_p = build_parser()
    parser.prog = "ngm-torch"
    parser.description = "NextGenMap-style short-read mapper (PyTorch/CUDA port)"
    map_p.add_argument("--device", default="cuda",
                       help="torch device to map on: cuda (default) or cpu")
    return parser


def parse(argv: list[str]):
    """(argv with the verb, parsed arguments, NgmConfig) of a `map` command
    line (the verb may be omitted); raises NotImplementedError for flags
    outside the ported slice."""
    argv = list(argv)
    if argv and argv[0] not in ("map", "index", "-h", "--help"):
        argv = ["map"] + argv
    parser = _parser()
    a = parser.parse_args(argv)
    if a.verb != "map":
        raise NotImplementedError(
            "only the `map` verb is ported; build indexes with `ngm-tpu index`"
        )
    for attr, is_set, what in _UNPORTED:
        if is_set(getattr(a, attr)):
            raise NotImplementedError(f"not in the PyTorch port yet: {what}")
    if not (a.qry or a.qry1):
        parser.error("need -q or -1/-2 query reads")
    if a.paired and a.qry1:
        parser.error("-p (interleaved) conflicts with -1/-2")
    if bool(a.qry1) != bool(a.qry2):
        parser.error("-1 and -2 must be given together")
    cfg = config_from_args(a)
    check_slice(cfg)
    return argv, a, cfg


def run(argv: list[str]):
    """Parse `argv`, map, return the run's RunStats."""
    argv, a, cfg = parse(argv)
    from nextgenmap_tpu_torch.pipeline.runner import run_mapping

    return run_mapping(
        cfg, a.reference, a.qry, a.output,
        cmdline=shlex.join(["ngm-torch"] + argv), qry1=a.qry1, qry2=a.qry2,
        paired_interleaved=a.paired, device=a.device,
    )


def main(argv: list[str] | None = None) -> int:
    run(sys.argv[1:] if argv is None else argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
