"""BAM in the port: --bam output, the port's copy of io/bam.py, and BAM and
SAM read input.

  * the port's --bam records, decoded by its read_bam, equal its SAM
    records (tests/test_bam.py), and its BGZF reads as gzip;
  * the port's BamTextWriter writes the reference's bytes for the same SAM
    text, and each read_bam decodes the other's file alike;
  * the port's CLI maps BAM input and SAM input (reverse records among
    them) to the records of its FASTQ run, which equal the JAX CLI's
    (tests/test_sam_input.py).
Tolerance: exact equality (bytes, SAM records).
"""

import gzip

import numpy as np
import pytest

pytest.importorskip("jax")

from nextgenmap_tpu.cli import main as jax_main  # noqa: E402
from nextgenmap_tpu.io import bam as jbam  # noqa: E402
from nextgenmap_tpu_torch import synthetic  # noqa: E402
from nextgenmap_tpu_torch.cli import main as torch_main  # noqa: E402
from nextgenmap_tpu_torch.io import bam as tbam  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

N = 100


@pytest.fixture(scope="module")
def bam_dir(tmp_path_factory):
    """A FASTQ run of the port and of the JAX CLI, and the port's --bam run
    of the same reads."""
    d = tmp_path_factory.mktemp("torch_bam")
    g = synthetic.repeat_genome(30_000, n_repeats=4, min_len=500,
                                max_len=1000, seed=4)
    synthetic.write_fasta(str(d / "ref.fa"), "chr1", g)
    codes, pos, strand = synthetic.simulate_reads(g, N, 100, 0.02, seed=5)
    synthetic.write_fastq(str(d / "reads.fq"), codes, pos, strand)
    base = _base(d)
    assert jax_main(base + ["-q", str(d / "reads.fq"),
                            "-o", str(d / "jax.sam")]) == 0
    for out, extra in (("out.sam", []), ("out.bam", ["--bam"])):
        assert torch_main(base + ["-q", str(d / "reads.fq"), "-o",
                                  str(d / out), "--device", "cpu",
                                  *extra]) == 0
    return d


def _base(d):
    return ["map", "-r", str(d / "ref.fa"), "-k", "11", "--batch-size", "32",
            "--no-progress", "--skip-save"]


def _records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


def test_bam_matches_sam(bam_dir):
    sam = [ln.rstrip("\n").split("\t") for ln in _records(bam_dir / "out.sam")]
    header, refs, recs = tbam.read_bam(str(bam_dir / "out.bam"))
    assert refs == [("chr1", 30_000)]
    assert "@SQ\tSN:chr1\tLN:30000" in header
    assert len(recs) == len(sam) == N
    for s, b in zip(sam, recs):
        assert s[:11] == b[:11]


def test_bgzf_is_gzip_compatible(bam_dir):
    raw = gzip.decompress((bam_dir / "out.bam").read_bytes())
    assert raw[:4] == b"BAM\x01"


def test_bam_writer_bytes_equal_reference(bam_dir, tmp_path):
    """The same SAM text through both BamTextWriters, in uneven pieces:
    byte-identical BAM, and each reader decodes both files alike."""
    text = (bam_dir / "out.sam").read_text()   # the header included
    cuts = np.random.default_rng(6).integers(0, len(text), 40)
    pieces = np.split(np.frombuffer(text.encode(), np.uint8), np.sort(cuts))
    for mod, name in ((jbam, "ref.bam"), (tbam, "port.bam")):
        w = mod.BamTextWriter(str(tmp_path / name))
        for p in pieces:
            w.write(p.tobytes().decode())
        w.close()
    port = (tmp_path / "port.bam").read_bytes()
    assert port == (tmp_path / "ref.bam").read_bytes()
    assert tbam.read_bam(str(tmp_path / "ref.bam")) == jbam.read_bam(
        str(tmp_path / "port.bam"))


def _fastq_to_sam(fq, sam, revcomp_every=3):
    """Unaligned-style SAM of a FASTQ; every 3rd record stored reverse-
    complemented with FLAG 0x10 (the reader restores its orientation)."""
    from nextgenmap_tpu_torch.io.encode import decode_seq, revcomp_codes
    from nextgenmap_tpu_torch.io.fastq import iter_reads

    with open(sam, "w") as f:
        f.write("@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:chrX\tLN:99999\n")
        for i, r in enumerate(iter_reads(fq)):
            codes, qual, flag = r.codes, r.qual, 4
            if i % revcomp_every == 0:
                codes, qual, flag = revcomp_codes(codes), qual[::-1], 16
            f.write(f"{r.name}\t{flag}\tchrX\t1\t0\t*\t*\t0\t0\t"
                    f"{decode_seq(codes)}\t{qual.decode('ascii')}\n")


@pytest.mark.parametrize("src", ["out.bam", "reads.sam"])
def test_map_from_bam_and_sam_input(bam_dir, src):
    if src == "reads.sam":
        _fastq_to_sam(str(bam_dir / "reads.fq"), str(bam_dir / src))
    out = bam_dir / f"from_{src}.sam"
    assert torch_main(_base(bam_dir) + ["-q", str(bam_dir / src), "-o",
                                        str(out), "--device", "cpu"]) == 0
    fastq = _records(bam_dir / "out.sam")
    assert _records(out) == fastq
    assert fastq == _records(bam_dir / "jax.sam")
