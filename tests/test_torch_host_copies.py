"""The port's copies of the JAX package's host modules == their originals.

The port keeps its own copy of every host module it uses (config, CLI
parser, score matrices, genome, host k-mer index, FASTA/FASTQ/SAM read
input, native host IO).  Each is held against its original on the same
inputs:
  * NgmConfig: the same fields, defaults and derived sizes, and the same
    to_json (the resume sidecar's hash); MappingStats.merge_counters;
  * build_parser + config_from_args: the same NgmConfig for every argv;
  * score_matrix for every scoring mode;
  * Genome from one FASTA (two chromosomes, lowercase, N) and its cache;
  * the host KmerIndex arrays, native and numpy builds, every collapse,
    and with allow_u32 (the sharded build);
  * the native CSR shard passes (ngm_shard_count / ngm_shard_fill through
    hostio.shard_csr), raw and canonical, and the .ngmt-shards artifacts:
    each package loads what the other saves, under the same paths;
  * ReadBatch from batch_single / batch_paired on plain and gzipped FASTQ,
    FASTA reads, SAM and BAM input, native and Python parsers;
  * format_sam bytes of the native writer, and the port's Python emit path
    against its native one;
  * the read simulator (io/simulate.py: the bench's and the graft entry's
    reads): random_genome, simulate_reads_fast (also on a genome of N runs,
    through its re-draw and its fallback to position 0), simulate_reads,
    simulate_pairs, and write_fastq's bytes.
Tolerance: exact equality (integers, bytes, strings).
"""

import dataclasses
import gzip

import numpy as np
import pytest

from nextgenmap_tpu import cli as jcli
from nextgenmap_tpu import config as jconfig
from nextgenmap_tpu import native as jnative
from nextgenmap_tpu.index import genome as jgenome
from nextgenmap_tpu.index import kmer_index as jkmer
from nextgenmap_tpu.io import fastq as jfastq
from nextgenmap_tpu.io import simulate as jsimulate
from nextgenmap_tpu.ops import scoring as jscoring
from nextgenmap_tpu.parallel import index_shard as jshard
from nextgenmap_tpu_torch import cli as tcli
from nextgenmap_tpu_torch import config as tconfig
from nextgenmap_tpu_torch import synthetic
from nextgenmap_tpu_torch.convert import (
    config_from_reference, index_from_reference,
)
from nextgenmap_tpu_torch.index import genome as tgenome
from nextgenmap_tpu_torch.index import kmer_index as tkmer
from nextgenmap_tpu_torch.io import fastq as tfastq
from nextgenmap_tpu_torch.io import simulate as tsimulate
from nextgenmap_tpu_torch.native import hostio
from nextgenmap_tpu_torch.ops import scoring as tscoring
from nextgenmap_tpu_torch.parallel import index_shard as tshard


def test_config_fields_and_defaults():
    ref, port = jconfig.NgmConfig(), tconfig.NgmConfig()
    assert ([(f.name, f.type) for f in dataclasses.fields(ref)]
            == [(f.name, f.type) for f in dataclasses.fields(port)])
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    for cfg in (dict(), dict(kmer=11, corridor=40), dict(bs_mapping=True),
                dict(max_read_hits=300, diag_bin_log2=5)):
        r, p = ref.replace(**cfg), port.replace(**cfg)
        assert config_from_reference(r) == p
        for L in (50, 100, 150, 1000):
            assert r.corridor_for(L) == p.corridor_for(L)
            assert r.kmers_per_read(L) == p.kmers_per_read(L)
            for n in (10_000, 4_600_000, 3_000_000_000):
                assert (r.resolved_read_hits(n, L)
                        == p.resolved_read_hits(n, L))
    for bad in (dict(kmer=9), dict(slam_seq=3), dict(gap_extend_penalty=30),
                dict(kmer_skip=2, read_kmer_skip=2)):
        with pytest.raises(ValueError):
            ref.replace(**bad).validate()
        with pytest.raises(ValueError):
            port.replace(**bad).validate()


BASE = ["map", "-r", "ref.fa", "-q", "reads.fq"]


@pytest.mark.parametrize("extra", [
    [], ["--end-to-end"], ["--bs-mapping", "--bs-cutoff", "3"],
    ["--slam-seq", "2"], ["-n", "2", "--strata"], ["-p"],
    ["--kmer-skip", "2"], ["--read-kmer-skip", "3"], ["-g", "0,1"],
    ["-k", "11", "-s", "0.7", "-i", "0.8", "-R", "0.6", "--max-cmrs", "16",
     "-I", "100", "-X", "700", "--pair-score-cutoff", "0.8"],
    ["--no-unal", "--hard-clip", "--rg-id", "x", "--rg-sm", "y",
     "--rg-lb", "l", "--rg-pl", "p", "--rg-pu", "u"],
    ["--match-bonus", "7", "--mismatch-penalty", "9", "--gap-read-penalty",
     "25", "--gap-ref-penalty", "30", "--gap-extend-penalty", "5",
     "--affine", "--sw-backend", "xla"],
    ["--batch-size", "64", "--read-len", "120", "--corridor", "24",
     "--qry-start", "4", "--qry-count", "8", "--max-read-hits", "256",
     "--kmer-min", "2", "--max-freq", "500", "-t", "3", "--skip-save",
     "--silent-clip", "--no-progress"],
])
def test_parser_maps_the_same_config(extra):
    argv = BASE + extra
    jparser, _ = jcli.build_parser()
    tparser, _ = tcli.build_parser()
    ref = jcli.config_from_args(jparser.parse_args(argv))
    port = tcli.config_from_args(tparser.parse_args(argv))
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)


def test_config_json_round_trip():
    """to_json is the reference's byte for byte (the resume sidecar hashes
    it), and from_json inverts it."""
    for cfg in (dict(), dict(kmer=11, corridor=40, rg_id="x", bam=True),
                dict(megabatch=4, threads=3, sensitivity=0.3)):
        ref, port = jconfig.NgmConfig(**cfg), tconfig.NgmConfig(**cfg)
        assert port.to_json() == ref.to_json()
        assert tconfig.NgmConfig.from_json(ref.to_json()) == port


def test_stats_merge_counters():
    """merge_counters folds the same fields and phase times as the
    reference's."""
    from nextgenmap_tpu.utils import stats as jstats
    from nextgenmap_tpu_torch.utils import stats as tstats

    assert tstats.MappingStats._COUNTERS == jstats.MappingStats._COUNTERS
    out = []
    for mod in (jstats, tstats):
        a, b = mod.MappingStats(), mod.MappingStats()
        for i, f in enumerate(mod.MappingStats._COUNTERS):
            setattr(a, f, i + 1)
            setattr(b, f, 10 * i + 3)
        a.add_time("write", 0.5)
        b.add_time("write", 0.25)
        b.add_time("format", 1.0)
        a.merge_counters(b)
        out.append(({f: getattr(a, f) for f in mod.MappingStats._COUNTERS},
                    a.timing))
    assert out[0] == out[1]


def test_parser_maps_the_same_config_paired_files():
    argv = ["map", "-r", "ref.fa", "-1", "a.fq", "-2", "b.fq"]
    a = tcli.build_parser()[0].parse_args(argv)
    b = jcli.build_parser()[0].parse_args(argv)
    assert (a.qry1, a.qry2, a.qry) == (b.qry1, b.qry2, b.qry)
    assert (dataclasses.asdict(tcli.config_from_args(a))
            == dataclasses.asdict(jcli.config_from_args(b)))


@pytest.mark.parametrize("mode", [
    dict(), dict(bs_mapping=True), dict(slam_seq=1), dict(slam_seq=2),
    dict(bs_mapping=True, slam_seq=2), dict(match_bonus=1),
    dict(match_bonus=7, mismatch_penalty=11),
])
def test_score_matrix_every_mode(mode):
    ref, port = jconfig.NgmConfig(**mode), tconfig.NgmConfig(**mode)
    for strand in (0, 1):
        a = jscoring.score_matrix(ref, strand)
        b = tscoring.score_matrix(port, strand)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("copies")
    g = synthetic.repeat_genome(30_000, n_repeats=4, min_len=300,
                                max_len=800, seed=61)
    seq = bytearray(b"ACGTN"[c] for c in g)
    seq[100:140] = b"N" * 40
    seq[500:600] = bytes(seq[500:600]).lower()
    with open(d / "ref.fa", "wb") as f:
        f.write(b">chrA some description\n")
        for i in range(0, 18_000, 61):
            f.write(bytes(seq[i:min(i + 61, 18_000)]) + b"\n")
        f.write(b"\n>chrB\n" + bytes(seq[18_000:]) + b"\n")
    return d


def test_genome_from_the_same_fasta(fasta, tmp_path):
    ref = jgenome.Genome.from_fasta(str(fasta / "ref.fa"))
    port = tgenome.Genome.from_fasta(str(fasta / "ref.fa"))
    np.testing.assert_array_equal(ref.codes, port.codes)
    assert ref.names == port.names == ["chrA", "chrB"]
    np.testing.assert_array_equal(ref.starts, port.starts)
    np.testing.assert_array_equal(ref.lengths, port.lengths)
    assert ref.sha1() == port.sha1()
    assert ref.cache_path("x.fa") == port.cache_path("x.fa")
    pos = np.array([0, 17_999, 18_000, 20_047, 20_048, 31_000])
    for a, b in zip(ref.abs_to_chrom(pos), port.abs_to_chrom(pos)):
        np.testing.assert_array_equal(a, b)
    for start, n in ((-5, 20), (17_990, 30), (port.size - 3, 10)):
        np.testing.assert_array_equal(ref.extract(start, n),
                                      port.extract(start, n))
    ref.save(str(tmp_path / "g.npz"))       # the two share the memo file
    back = tgenome.Genome.load(str(tmp_path / "g.npz"))
    np.testing.assert_array_equal(back.codes, port.codes)
    assert back.names == port.names


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("collapse,canonical,skip", [
    ("none", True, 1), ("none", False, 1), ("none", True, 2),
    ("ct", False, 1), ("ga", False, 2),
])
def test_host_kmer_index_arrays(fasta, monkeypatch, native, collapse,
                                canonical, skip):
    if not native:
        monkeypatch.setattr(jnative, "lib", lambda: None)
        monkeypatch.setattr(hostio, "lib", lambda: None)
    codes = tgenome.Genome.from_fasta(str(fasta / "ref.fa")).codes
    ref = jkmer.KmerIndex.build(codes, 10, skip, 20, collapse, "s",
                                canonical=canonical)
    port = tkmer.KmerIndex.build(codes, 10, skip, 20, collapse, "s",
                                 canonical=canonical)
    for f in ("k", "skip", "max_freq", "collapse", "genome_sha1",
              "canonical"):
        assert getattr(ref, f) == getattr(port, f)
    for f in ("offsets", "positions"):
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ref.device_arrays(), port.device_arrays()):
        np.testing.assert_array_equal(a, b)
    conv = index_from_reference(ref)
    assert isinstance(conv, tkmer.KmerIndex)
    np.testing.assert_array_equal(conv.positions, port.positions)
    assert (jkmer.KmerIndex.cache_path("r.fa", 10, skip, collapse, canonical)
            == tkmer.KmerIndex.cache_path("r.fa", 10, skip, collapse,
                                          canonical))


@pytest.mark.parametrize("canonical", [True, False])
def test_host_kmer_index_allow_u32(fasta, canonical):
    """allow_u32 (the sharded build) keeps canonical entries in both."""
    codes = tgenome.Genome.from_fasta(str(fasta / "ref.fa")).codes
    ref = jkmer.KmerIndex.build(codes, 11, 2, 50, canonical=canonical,
                                allow_u32=True)
    port = tkmer.KmerIndex.build(codes, 11, 2, 50, canonical=canonical,
                                 allow_u32=True)
    assert ref.canonical == port.canonical == canonical
    assert ref.n_buckets == port.n_buckets == 4**11
    for f in ("offsets", "positions"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(port, f))


@pytest.mark.parametrize("canonical", [True, False])
def test_shard_csr_native(fasta, canonical):
    """hostio.shard_csr (the port's ngm_shard_count / ngm_shard_fill) ==
    the JAX package's native passes, at ranges that cut rows apart."""
    assert hostio.lib() is not None and jnative.lib() is not None
    codes = tgenome.Genome.from_fasta(str(fasta / "ref.fa")).codes
    idx = jkmer.KmerIndex.build(codes, 10, 1, 20, canonical=canonical)
    mul = 2 if canonical else 1
    for lo, hi in ((0, 9_000), (7_500, 21_000), (20_000, 31_000), (5, 6)):
        ref = jnative.shard_csr(idx.offsets, idx.positions, lo * mul,
                                hi * mul)
        port = hostio.shard_csr(idx.offsets, idx.positions, lo * mul,
                                hi * mul)
        for a, b in zip(ref, port):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dual", [False, True])
def test_shard_artifacts_cross_load(fasta, tmp_path, dual):
    """The .ngmt-shards artifact and the per-shard ones: the same paths,
    and each package loads what the other saved, array for array."""
    codes = tgenome.Genome.from_fasta(str(fasta / "ref.fa")).codes
    if dual:
        index = tuple(jkmer.KmerIndex.build(codes, 10, 2, 50, c)
                      for c in ("ct", "ga"))
        ref = jshard.ShardedIndex.build_dual(*index, codes, 3, 2_000)
        port = tshard.ShardedIndex.build_dual(*index_from_reference(index),
                                              codes, 3, 2_000)
    else:
        index = jkmer.KmerIndex.build(codes, 10, 2, 50, canonical=True)
        ref = jshard.ShardedIndex.build(index, codes, 3, 2_000)
        port = tshard.ShardedIndex.build(index_from_reference(index), codes,
                                         3, 2_000)
    args = ("r.fa", 10, 2, 3, 2_000, 50, dual, not dual)
    assert (jshard.ShardedIndex.cache_path(*args)
            == tshard.ShardedIndex.cache_path(*args))
    assert (jshard.ShardedIndex.shard_cache_path("r.fa", 1, *args[1:])
            == tshard.ShardedIndex.shard_cache_path("r.fa", 1, *args[1:]))
    fields = ("genome", "offsets", "positions", "base", "core_lo", "core_hi")
    for saver, loader, tag in ((port, jshard, "t"), (ref, tshard, "j")):
        path = str(tmp_path / f"{tag}.npz")
        saver.save(path, "sha")
        back = loader.ShardedIndex.load(path, "sha", max_freq=50)
        assert (back.n_shards, back.max_freq, back.dual, back.canonical) == (
            3, 50, dual, not dual)
        for f in fields:
            np.testing.assert_array_equal(getattr(back, f), getattr(ref, f))
        assert loader.ShardedIndex.load(path, "other") is None
        assert loader.ShardedIndex.load(path, "sha", max_freq=7) is None
        saver.save_shards(lambda s: str(tmp_path / f"{tag}{s}.npz"), "sha")
    for s in range(3):
        with np.load(tmp_path / f"t{s}.npz") as a, \
                np.load(tmp_path / f"j{s}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                np.testing.assert_array_equal(a[f], b[f])


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Reads of varied length with N bases, as FASTQ, gzipped FASTQ, FASTA
    and SAM (with a reverse-strand record and a secondary one)."""
    d = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(62)
    recs = []
    for i in range(37):
        n = int(rng.integers(20, 130))
        seq = bytes(b"ACGTN"[c] for c in rng.integers(0, 5, n))
        qual = bytes(33 + int(q) for q in rng.integers(2, 40, n))
        recs.append((f"read{i}/{1 + i % 2}", seq, qual))
    fq = b"".join(b"@%s extra\n%s\n+\n%s\n" % (n.encode(), s, q)
                  for n, s, q in recs)
    (d / "r.fq").write_bytes(fq)
    with gzip.open(d / "r.fq.gz", "wb") as f:
        f.write(fq)
    (d / "r.fa").write_bytes(b"".join(b">%s\n%s\n%s\n" % (n.encode(), s[:10],
                                                          s[10:])
                                      for n, s, _ in recs))
    sam = [b"@HD\tVN:1.6\n"]
    for j, (n, s, q) in enumerate(recs):
        flag = 16 if j % 3 == 0 else 0
        sam.append(b"%s\t%d\tchr\t1\t0\t*\t*\t0\t0\t%s\t%s\n"
                   % (n.split("/")[0].encode(), flag, s, q))
    sam.append(b"dup\t256\tchr\t1\t0\t*\t*\t0\t0\tACGT\t*\n")
    (d / "r.sam").write_bytes(b"".join(sam))
    return d


def _assert_batches_equal(ref, port):
    assert len(ref) == len(port) > 0
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.lengths, b.lengths)
        assert a.codes.dtype == b.codes.dtype
        assert a.lengths.dtype == b.lengths.dtype
        assert (a.names, a.quals, a.n, a.paired) == (b.names, b.quals, b.n,
                                                     b.paired)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", ["r.fq", "r.fq.gz", "r.fa", "r.sam"])
def test_read_batches(reads, monkeypatch, native, name):
    if not native:
        monkeypatch.setattr(jnative, "lib", lambda: None)
        monkeypatch.setattr(hostio, "lib", lambda: None)
    path = str(reads / name)
    assert jfastq.peek_read_len(path) == tfastq.peek_read_len(path)
    for args in ((16, 100, 0, 0), (16, 140, 3, 20)):
        _assert_batches_equal(list(jfastq.batch_single(path, *args)),
                              list(tfastq.batch_single(path, *args)))
    # interleaved pairs from one file (an even count of records)
    for args in ((8, 100, 0, 36), (8, 100, 2, 30)):
        _assert_batches_equal(list(jfastq.batch_paired(path, None, *args)),
                              list(tfastq.batch_paired(path, None, *args)))
    _assert_batches_equal(
        list(jfastq.batch_paired(path, path, 10, 120)),
        list(tfastq.batch_paired(path, path, 10, 120)))


@pytest.mark.parametrize("native", [True, False])
def test_bam_input_batches(reads, tmp_path, monkeypatch, native):
    """BAM read input: the reads fixture's SAM written as BAM batches alike
    in both packages (reverse records restored, the secondary one
    skipped)."""
    from nextgenmap_tpu.io import bam as jbam

    if not native:
        monkeypatch.setattr(jnative, "lib", lambda: None)
        monkeypatch.setattr(hostio, "lib", lambda: None)
    path = str(tmp_path / "r.bam")
    w = jbam.BamTextWriter(path)
    w.write((reads / "r.sam").read_text())
    w.close()
    assert jfastq.peek_read_len(path) == tfastq.peek_read_len(path)
    _assert_batches_equal(list(jfastq.batch_single(path, 16, 130)),
                          list(tfastq.batch_single(path, 16, 130)))
    _assert_batches_equal(list(jfastq.batch_paired(path, None, 8, 100, 2, 30)),
                          list(tfastq.batch_paired(path, None, 8, 100, 2,
                                                   30)))


def _format_args(rng, n, lmax, mo, genome):
    mapped = rng.random(n) < 0.8
    names = [f"r{i}" for i in range(n)]
    lens = rng.integers(lmax // 2, lmax + 1, n).astype(np.int32)
    ops = rng.integers(0, 3, (n, mo)).astype(np.uint8)
    n_ops = rng.integers(1, mo, n).astype(np.int32)
    return dict(
        names=names,
        aligned_codes=rng.integers(0, 5, (n, lmax)).astype(np.uint8),
        read_len=lens,
        quals=[None if i % 4 == 0 else bytes(33 + (i + j) % 40
                                              for j in range(lens[i]))
               for i in range(n)],
        qual_rev=rng.integers(0, 2, n).astype(np.uint8),
        flag=np.where(mapped, 16 * rng.integers(0, 2, n), 4).astype(np.int32),
        chrom_pos=rng.integers(0, 1000, n).astype(np.int64),
        rnames=[("chrA" if m else "*") for m in mapped],
        mapq=rng.integers(0, 61, n).astype(np.int32),
        score=rng.integers(0, 900, n).astype(np.int32),
        ops=ops, n_ops=n_ops,
        q_start=rng.integers(0, 5, n).astype(np.int32),
        q_end=(lens - 1 - rng.integers(0, 5, n)).astype(np.int32),
        genome_codes=genome,
        gpos_abs=rng.integers(0, genome.shape[0] - 2 * mo, n).astype(np.int64),
        rnexts=["*" if i % 2 else "=" for i in range(n)],
        pnext=rng.integers(0, 1000, n).astype(np.int64),
        tlen=rng.integers(-500, 500, n).astype(np.int64),
        identity=rng.random(n).astype(np.float32),
        is_mapped=mapped.astype(np.uint8),
    )


@pytest.mark.parametrize("clip_mode,rg", [(0, ""), (1, "\tRG:Z:g"), (2, "")])
def test_format_sam_bytes_native(clip_mode, rg):
    assert hostio.lib() is not None and jnative.lib() is not None
    rng = np.random.default_rng(63 + clip_mode)
    genome = rng.integers(0, 5, 5000).astype(np.uint8)
    args = _format_args(rng, 50, 120, 160, genome)
    ref = jnative.format_sam(**args, rg_suffix=rg, clip_mode=clip_mode)
    port = hostio.format_sam(**args, rg_suffix=rg, clip_mode=clip_mode)
    assert port == ref and len(port) > 0


def test_emit_python_path_equals_native(fasta, tmp_path, monkeypatch):
    """The port's single-end emit: the Python SamWriter path writes the
    bytes of the native formatter, mapped, unmapped and reverse rows."""
    import io

    from nextgenmap_tpu_torch.io.fastq import ReadBatch
    from nextgenmap_tpu_torch.io.sam import SamWriter
    from nextgenmap_tpu_torch.models.mapper import MapResult
    from nextgenmap_tpu_torch.pipeline import runner
    from nextgenmap_tpu_torch.utils.stats import MappingStats

    genome = tgenome.Genome.from_fasta(str(fasta / "ref.fa"))
    rng = np.random.default_rng(64)
    B, L, MO = 12, 60, 90
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, L, np.int32)
    lens[-2:] = [45, 30]
    codes[-2, 45:] = 4
    codes[-1, 30:] = 4
    n_ops = np.minimum(lens, 55).astype(np.int32)
    ops = np.full((B, MO), 255, np.uint8)
    ops[:, :55] = 0
    ops[1, 10:12] = 1
    ops[2, 20:22] = 2
    res = MapResult(
        mapped=np.arange(B) % 5 != 3, strand=(np.arange(B) % 2).astype(np.int32),
        pos=rng.integers(0, 17_000, B).astype(np.int32),
        mapq=rng.integers(0, 61, B).astype(np.int32),
        score=rng.integers(1, 600, B).astype(np.int32),
        second=np.zeros(B, np.int32), q_start=np.zeros(B, np.int32),
        q_end=(n_ops - 1).astype(np.int32), ops=ops, n_ops=n_ops,
        matches=(n_ops - 3).astype(np.int32), mismatches=np.full(B, 3, np.int32),
        indels=np.zeros(B, np.int32), n_candidates=np.ones(B, np.int32),
        proper=np.zeros(B, bool), fanout_overflow=np.int32(0),
        cmr_overflow=np.int32(0),
    )
    batch = ReadBatch(codes, lens, [f"q{i}" for i in range(B)],
                      [b"I" * int(n) if i % 3 else None
                       for i, n in enumerate(lens)], n=B)
    cfg = tconfig.NgmConfig(rg_id="grp")
    out = {}
    for native in (True, False):
        if not native:
            monkeypatch.setattr(hostio, "lib", lambda: None)
        buf = io.StringIO()
        runner.emit_single(SamWriter(genome, cfg, buf), batch, res,
                           MappingStats())
        out[native] = buf.getvalue()
    assert out[True] == out[False]
    assert out[True].count("\n") == B


def _n_run_genome() -> np.ndarray:
    """A genome mostly of N runs: most 100 bp windows hold an N, so
    simulate_reads_fast draws them again, and some fall back to 0."""
    g = tsimulate.random_genome(6_000, seed=71)
    for start in range(0, 6_000, 400):
        g[start + 50:start + 200] = 4
    return g


def _simulated(mod, case, tmp_path):
    g = mod.random_genome(40_000, seed=72)
    if case == "random_genome":
        return [mod.random_genome(n, seed=s) for n, s in ((1, 0), (12_345, 9))]
    if case == "simulate_reads_fast":
        return [mod.simulate_reads_fast(g, 500, read_len=100, snp_rate=0.02,
                                        seed=2),
                mod.simulate_reads_fast(_n_run_genome(), 300, read_len=100,
                                        snp_rate=0.05, seed=3)]
    if case == "simulate_reads":
        return [(r.name, r.codes, r.chrom, r.pos, r.strand, r.n_snps,
                 r.n_indels)
                for r in mod.simulate_reads(g, 60, read_len=100,
                                            snp_rate=0.02, indel_rate=0.01,
                                            seed=4)]
    if case == "simulate_pairs":
        return [(m.name, m.codes, m.pos, m.strand, m.n_snps, m.n_indels)
                for p in mod.simulate_pairs(g, 30, read_len=100,
                                            insert_mean=300, insert_sd=30,
                                            snp_rate=0.02, indel_rate=0.01,
                                            seed=5)
                for m in p]
    path = tmp_path / f"{mod.__name__.split('.')[0]}.fq"
    mod.write_fastq(str(path), mod.simulate_reads(g, 20, seed=6))
    return [path.read_bytes()]


def _assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("case", [
    "random_genome", "simulate_reads_fast", "simulate_reads",
    "simulate_pairs", "write_fastq"])
def test_read_simulator_copy(case, tmp_path):
    ref = _simulated(jsimulate, case, tmp_path)
    port = _simulated(tsimulate, case, tmp_path)
    assert len(ref) > 0
    _assert_same(ref, port)
    if case == "simulate_reads_fast":
        codes, pos, _ = port[1]
        assert (pos == 0).any() and (pos > 0).any()   # fell back, and not all
        assert (codes[pos > 0] < 4).all()
