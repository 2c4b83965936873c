"""Entry points of the port: the flagship step, and the several-device dry run.

    python -m nextgenmap_tpu_torch.graft_entry

Counterpart of the repository's root ``__graft_entry__.py``, on the same
workload: a 50 kbp random genome, k = 11, a host KmerIndex (max_freq
1000), 64 reads of 100 bp.

``entry(device)`` returns ``(fn, args)``: ``fn`` is the single-end step
``models/mapper.py::map_step`` with its statics bound (canonical index,
lazy scoring), ``args`` its tensors on `device` and its scalars.

``dryrun_multichip(n, device)`` maps one batch of 32 FR pairs through the
Mapper on n device slots with index shards (``ish`` = 2 when n is even and
at least 4): the ("dp", "ish") grid of one process, then, with ish >= 2,
the same grid laid out as ``--shard-across-hosts`` lays it out.  Both must
give the same pairs.  On fewer cards than slots the slots take the cards
in turn, so on one card n = 4 is four slots of ``cuda:0``.

Run as a module it calls ``entry()`` on the card and then
``dryrun_multichip`` over every card.  The entry points run on the card
unless the CPU is named; without a card, ``device="cuda"`` raises.
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace

import numpy as np
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.device import resolve_device
from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
from nextgenmap_tpu_torch.io.simulate import random_genome, simulate_reads_fast
from nextgenmap_tpu_torch.models.mapper import MapResult, Mapper, _on, map_step
from nextgenmap_tpu_torch.ops.scoring import score_matrix

_K = 11
_L = 100
_B = 64
# the legs of the dry run must agree on these fields (__graft_entry__.py)
LEG_FIELDS = ("pos", "strand", "mapped", "proper", "score")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def _setup(batch: int, genome_size: int = 50_000, seed: int = 0,
           paired: bool = False, canonical: bool = False, device="cuda"):
    """(cfg, genome, host index, step args, statics): __graft_entry__.py's
    workload (:31-70), the args on `device`."""
    dev = resolve_device(device)
    cfg = NgmConfig(kmer=_K)
    g = random_genome(genome_size, seed=seed)
    idx = KmerIndex.build(g, k=_K, skip=cfg.kmer_skip, max_freq=1000,
                          canonical=canonical)
    off, pos = idx.device_arrays()
    if paired:
        # vectorized FR pairs: mate1 fwd at p, mate2 rc at p+insert-L
        rng = np.random.default_rng(seed + 1)
        n_pairs = batch // 2
        insert = rng.integers(_L + 50, 500, size=n_pairs)
        p1 = rng.integers(0, genome_size - 520, size=n_pairs)
        w1 = g[p1[:, None] + np.arange(_L)[None, :]]
        p2 = p1 + insert - _L
        w2 = g[p2[:, None] + np.arange(_L)[None, :]]
        w2 = np.where(w2 < 4, 3 - w2.astype(np.int16), w2)[:, ::-1].astype(np.uint8)
        codes = np.empty((batch, _L), np.uint8)
        codes[0::2] = w1
        codes[1::2] = w2
    else:
        codes, _, _ = simulate_reads_fast(g, batch, read_len=_L,
                                          snp_rate=0.02, seed=seed + 1)
    lens = np.full(batch, _L, np.int32)
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    statics = dict(
        k=_K, fanout_cap=cfg.max_kmer_fanout,
        hit_cap=cfg.resolved_read_hits(len(pos), _L),
        max_cmrs=cfg.max_cmrs, diag_bin_log2=cfg.diag_bin_log2,
        band=cfg.corridor_for(_L), min_kmer_hits=1,
        read_stride=cfg.read_kmer_skip,
        canonical=canonical,
    )
    args = (
        _on(g, np.uint8, dev), _on(off, np.int32, dev),
        _on(pos, np.int32, dev), _on(codes, np.uint8, dev),
        _on(lens, np.int32, dev), _on(mats, np.int32, dev),
        20, 20, 20, 0.5, 1000, 0.65, 0.5,
    )
    return cfg, g, idx, args, statics


def entry(device="cuda"):
    """(fn, example_args) of the flagship step, with the production
    configuration: canonical k-mer index + lazy scoring."""
    _, _, _, args, statics = _setup(_B, canonical=True, device=device)
    return partial(map_step, **statics), args


def slots(n: int, device="cuda") -> list[torch.device]:
    """n device slots of `device`'s kind: CPU slots, or the cards in turn
    (n slots of cuda:0 on one card)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def dryrun_multichip(n_devices: int, device="cuda"):
    """The paired step over n device slots through the Mapper (what the
    CLI's --index-shards/--devices drive), in both layouts: the local
    ("dp", "ish") grid, and with ish >= 2 the --shard-across-hosts grid in
    one process (every shard column local).  Returns (local result,
    cross-host result or None), both checked as __graft_entry__.py checks
    them (:83-140)."""
    where = slots(n_devices, device)
    ish = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    cfg, g, idx, args, _ = _setup(_B, seed=3, paired=True, device="cpu")
    cfg = cfg.replace(devices=n_devices, index_shards=ish)
    genome = SimpleNamespace(codes=g)   # the Mapper reads only .codes
    codes = args[3].numpy()
    lens = args[4].numpy()
    res = Mapper(cfg, genome, _L, index=idx, device=where).map_batch_paired(
        codes, lens)
    n_mapped = int(res.mapped.sum())
    n_proper = int(res.proper.sum())
    _check(n_mapped > 0, "dryrun mapped zero reads")
    _check(n_proper >= _B // 2,
           f"dryrun resolved too few proper pairs: {n_proper}")
    print(f"dryrun_multichip ok [local (dp,ish) grid]: slots={n_devices} "
          f"({', '.join(map(str, where))}) ish={ish}, mapped "
          f"{n_mapped}/{_B}, proper={n_proper}", flush=True)
    if ish < 2:
        return res, None
    # leg 2: the cross-host layout (the process-major grid), same shard
    # count -> results must match leg 1 exactly
    res_xh = Mapper(cfg.replace(shard_hosts=True), genome, _L, index=idx,
                    device=where).map_batch_paired(codes, lens)
    for f in LEG_FIELDS:
        _check(torch.equal(getattr(res, f).cpu(), getattr(res_xh, f).cpu()),
               f"cross-host layout diverged from the local grid on {f}")
    print(f"dryrun_multichip ok [cross-host global ish grid]: "
          f"slots={n_devices} ish={ish}, identical to the local grid "
          f"({n_mapped}/{_B} mapped, proper={n_proper})", flush=True)
    return res, res_xh


def main() -> int:
    fn, args = entry()
    out: MapResult = fn(*args)
    torch.cuda.synchronize()
    print("entry ok: mapped", int(out.mapped.sum()), "/", _B, flush=True)
    dryrun_multichip(torch.cuda.device_count())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
