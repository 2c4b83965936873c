"""Seeded inputs on the device: the genome and the pool of reads.

Vectorised generators in the spirit of the port's own (``nextgenmap_tpu_
torch/synthetic.py``: ``repeat_genome_large``, ``simulate_reads``,
``simulate_pairs`` and ``simulate_long_reads``), drawn with one
``torch.Generator`` on the run's device in a few large calls, so a
64 Mbp genome and a pool of a quarter million reads cost about a second of
set-up.  The models, each a group of a configuration or a traffic file:

  genome   ("genome" group) background bases at the stated GC share, then
           the interspersed repeat families and simple repeats of
           `families`, laid out end to end with no overlap in a random
           order, separated by background gaps (exponential, scaled so the
           families take their shares of the genome), then the segmental
           duplications of `duplications` copied over it.  A family has
           `consensi` random consensus sequences of `consensus` bases; each
           copy is a fragment of one of them, its length drawn between
           `min` and `max` with mean `mean` (min + (max - min) u^a), taken
           from the 3' end (`truncation` "5p", as LINEs are) or anywhere
           ("any"), on a random strand, with substitutions at a rate drawn
           per copy from `divergence` [lo, hi].  A family with `unit`
           [lo, hi] is simple repeats: each copy repeats a random unit of
           that many bases.  Duplications copy a random segment of the
           genome (repeats included) to another place, on a random strand,
           diverged as above; where two overlap, the later one wins.
  reads    (traffic file) wgsim's model: a window of the genome (uniform,
           or only windows that touch no planted copy, source or
           duplication: `region` "unique"), substitutions at
           error_rate + mutation_rate x (1 - indel_fraction), and indels
           starting at mutation_rate x indel_fraction a base, half
           insertions of random bases and half deletions, of 1 + a
           geometric number of bases (extended with probability
           `indel_extend`, at most MAX_INDEL); half of the reads
           reverse-complemented.  Pairs are FR fragments of
           round(N(insert_mean, insert_sd)) bp (at least L + 10), which mate
           is first drawn per pair, each mate with its own truth.  wgsim
           applies its mutations to a diploid genome that both mates share;
           here each read draws its own at the same rate.

Truth is the window's first genome base and the strand (0 forward, 1
reverse), as the port's read names carry it.  Codes are 0..3 for A, C, G,
T, so 3 - x is the complement.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

I32 = torch.int32
U8 = torch.uint8
MAX_INDEL = 8          # longest indel a read draws


class Pool(NamedTuple):
    """The reads of a run, staged on the device."""

    reads: torch.Tensor      # [N, B, L] uint8
    lengths: torch.Tensor    # [N, B] int32
    truth_pos: torch.Tensor  # [N, B] int64
    truth_strand: torch.Tensor  # [N, B] int32


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


def _rand(n, gen, dev, dtype=torch.float32):
    return torch.rand(n, generator=gen, device=dev, dtype=dtype)


def _bases(n: int, gc: float, gen, dev) -> torch.Tensor:
    """n random codes, C and G at gc / 2 each, A and T at (1 - gc) / 2."""
    u = _rand(n, gen, dev)
    at = (1.0 - gc) / 2
    return ((u >= at).to(U8) + (u >= at + gc / 2).to(U8)
            + (u >= at + gc).to(U8))


def _mutate(x: torch.Tensor, rate, gen) -> torch.Tensor:
    """Each base replaced by one of the three others with probability
    `rate` (a float, or a tensor of x's shape)."""
    if not torch.is_tensor(rate) and rate <= 0:
        return x
    hit = _rand(x.shape, gen, x.device) < rate
    shift = torch.randint(1, 4, x.shape, generator=gen, device=x.device,
                          dtype=U8)
    return torch.where(hit, (x + shift) % 4, x)


def _lengths(n: int, f: dict, gen, dev) -> torch.Tensor:
    """n copy lengths in [min, max] with mean `mean`: min + (max - min) u^a,
    a = (max - min) / (mean - min) - 1."""
    lo, hi, mean = float(f["min"]), float(f["max"]), float(f["mean"])
    if not lo < mean < hi:
        raise ValueError(f"copy lengths need min < mean < max: {f}")
    a = (hi - lo) / (mean - lo) - 1.0
    u = _rand(n, gen, dev, torch.float64)
    return (lo + (hi - lo) * u.pow(a)).round().long()


def _divergence(n: int, f: dict, gen, dev) -> torch.Tensor:
    lo, hi = (float(x) for x in f["divergence"])
    return lo + (hi - lo) * _rand(n, gen, dev)


def _spans(lens: torch.Tensor):
    """(copy of each base, offset of each base in its copy) of copies of
    `lens` bases laid end to end."""
    dev = lens.device
    rep = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev),
                                  lens)
    first = torch.cumsum(lens, 0) - lens
    return rep, torch.arange(rep.shape[0], device=dev) - first[rep]


def _interval_cover(starts: torch.Tensor, lens: torch.Tensor,
                    size: int) -> torch.Tensor:
    """[size] bool: positions inside any [start, start + len)."""
    d = torch.zeros(size + 1, dtype=I32, device=starts.device)
    one = torch.ones_like(starts, dtype=I32)
    d.index_add_(0, starts, one)
    d.index_add_(0, starts + lens, -one)
    return torch.cumsum(d[:size], 0) > 0


def _copies(spec: dict, G: int, gen, dev):
    """Every family's copies: (consensus bases, and per copy: its start in
    them, length, strand, divergence)."""
    gc = float(spec["gc"])
    cons, src, lens, strand, div = [], [], [], [], []
    base = 0
    for f in spec["families"]:
        n = int(round(float(f["share"]) * G / float(f["mean"])))
        ln = _lengths(n, f, gen, dev)
        if "unit" in f:
            # simple repeats: each copy is its own consensus, a unit repeated
            u_lo, u_hi = (int(x) for x in f["unit"])
            units = _bases(n * u_hi, gc, gen, dev).reshape(n, u_hi)
            ulen = torch.randint(u_lo, u_hi + 1, (n,), generator=gen,
                                 device=dev)
            rep, off = _spans(ln)
            cons.append(units[rep, off % ulen[rep]])
            src.append(base + torch.cumsum(ln, 0) - ln)
            base += int(ln.sum())
        else:
            C, m = int(f["consensus"]), int(f.get("consensi", 1))
            if int(ln.max()) > C:
                raise ValueError(f"copies longer than the consensus: {f}")
            cons.append(_bases(m * C, gc, gen, dev))
            which = torch.randint(0, m, (n,), generator=gen, device=dev)
            if f["truncation"] == "5p":
                off = C - ln
            elif f["truncation"] == "any":
                off = (_rand(n, gen, dev, torch.float64)
                       * (C - ln + 1)).long()
            else:
                raise ValueError(f"truncation {f['truncation']!r}: 5p or any")
            src.append(base + which * C + off)
            base += m * C
        lens.append(ln)
        strand.append(torch.randint(0, 2, (n,), generator=gen, device=dev))
        div.append(_divergence(n, f, gen, dev))
    return (torch.cat(cons), torch.cat(src), torch.cat(lens),
            torch.cat(strand), torch.cat(div))


def _oriented(seq_at, start, lens, strand, rep, off):
    """The bases of copies read from `seq_at` at [start, start + len), the
    reverse complement on strand 1."""
    fwd = strand[rep] == 0
    at = torch.where(fwd, start[rep] + off, start[rep] + lens[rep] - 1 - off)
    b = seq_at[at]
    return torch.where(fwd, b, 3 - b)


def make_genome(spec: dict, gen: torch.Generator, device):
    """(genome [G] uint8 codes 0..3, repeat cover [G] bool: every planted
    copy, duplication and duplication source) of a configuration's
    "genome" group."""
    G = int(spec["length"])
    dev = device
    g = _bases(G, float(spec["gc"]), gen, dev)
    cons, src, lens, strand, div = _copies(spec, G, gen, dev)
    n = lens.shape[0]
    order = torch.randperm(n, generator=gen, device=dev)
    src, lens, strand, div = src[order], lens[order], strand[order], div[order]
    free = G - int(lens.sum())
    if free <= 0:
        raise ValueError("the families' shares leave no background")
    gaps = -torch.log1p(-_rand(n + 1, gen, dev, torch.float64))
    gaps = (gaps / gaps.sum() * free).floor().long()
    starts = torch.cumsum(gaps[:n], 0) + torch.cumsum(lens, 0) - lens
    rep, off = _spans(lens)
    b = _oriented(cons, src, lens, strand, rep, off)
    g[starts[rep] + off] = _mutate(b, div[rep], gen)
    del cons, rep, off, b
    cov_s, cov_l = [starts], [lens]
    d = spec.get("duplications")
    if d:
        m = int(round(float(d["share"]) * G / 2 / float(d["mean"])))
        ln = _lengths(m, d, gen, dev)
        s_src = (_rand(m, gen, dev, torch.float64) * (G - ln)).long()
        dst = (_rand(m, gen, dev, torch.float64) * (G - ln)).long()
        st = torch.randint(0, 2, (m,), generator=gen, device=dev)
        rep, off = _spans(ln)
        seg = _mutate(_oriented(g, s_src, ln, st, rep, off),
                      _divergence(m, d, gen, dev)[rep], gen)
        at = dst[rep] + off
        owner = torch.full((G,), -1, dtype=torch.int64, device=dev)
        owner.scatter_reduce_(0, at, rep, reduce="amax")
        win = owner[at] == rep
        g[at[win]] = seg[win]
        cov_s += [s_src, dst]
        cov_l += [ln, ln]
    cover = _interval_cover(torch.cat(cov_s), torch.cat(cov_l), G)
    return g, cover


def _windows(genome: torch.Tensor, pos: torch.Tensor, width: int):
    cols = torch.arange(width, device=genome.device)
    return genome[pos[:, None] + cols]


def _starts(n: int, width: int, genome: torch.Tensor, cover, region: str,
            gen) -> torch.Tensor:
    """n window starts in [0, G - width): uniform, or ("unique") only those
    whose window touches no planted repeat."""
    G = genome.shape[0]
    if region == "uniform":
        return (_rand(n, gen, genome.device, torch.float64)
                * (G - width)).long()
    if region != "unique":
        raise ValueError(f"region {region!r}: uniform or unique")
    cs = torch.cat([cover.new_zeros(1, dtype=torch.int64),
                    torch.cumsum(cover.to(torch.int64), 0)])
    out = []
    have = 0
    while have < n:
        p = (_rand(4 * n, gen, genome.device, torch.float64)
             * (G - width)).long()
        p = p[(cs[p + width] - cs[p]) == 0]
        out.append(p)
        have += p.shape[0]
    return torch.cat(out)[:n]


def _indels(win: torch.Tensor, L: int, rate: float, extend: float,
            gen) -> torch.Tensor:
    """The first L bases of each window after indels that start at `rate`
    a base: half deletions of that base and the next ones, half insertions
    of random bases before it, 1 + Geometric(extend) bases long (at most
    MAX_INDEL)."""
    n, width = win.shape
    if rate <= 0:
        return win[:, :L]
    dev = win.device
    start = _rand(win.shape, gen, dev) < rate
    is_del = start & (_rand(win.shape, gen, dev) < 0.5)
    is_ins = start & ~is_del
    u = _rand(win.shape, gen, dev, torch.float64).clamp(min=1e-300)
    ln = (1 + (torch.log(u) / torch.log(torch.tensor(
        float(extend), dtype=torch.float64, device=dev))).floor()
          if extend > 0 else torch.ones_like(u))
    ln = ln.clamp(max=MAX_INDEL).to(I32)
    col = torch.arange(width, dtype=I32, device=dev)[None, :]
    dele = torch.cummax(torch.where(is_del, col + ln, 0), 1).values > col
    n_ins = torch.where(is_ins, ln, 0)
    emitted = n_ins + (~dele).to(I32)
    at = torch.cumsum(emitted, 1) - emitted          # first output slot
    if int(emitted.sum(1).min()) < L:
        raise RuntimeError("read window too short for its deletions")
    out = torch.empty((n, L), dtype=win.dtype, device=dev)
    rows = torch.arange(n, device=dev)[:, None].expand(n, width)
    for j in range(MAX_INDEL):
        m = (n_ins > j) & (at + j < L)
        if not bool(m.any()):
            break
        out[rows[m], (at[m] + j).long()] = torch.randint(
            0, 4, (int(m.sum()),), generator=gen, device=dev, dtype=win.dtype)
    slot = at + n_ins
    k = ~dele & (slot < L)
    out[rows[k], slot[k].long()] = win[k]
    return out


def _revcomp(x: torch.Tensor) -> torch.Tensor:
    return (3 - x).flip(1)


def rates(traffic: dict) -> tuple[float, float, float]:
    """(substitutions a base, indel starts a base, indel extension) of a
    traffic file's wgsim parameters."""
    e = float(traffic["error_rate"])
    r = float(traffic["mutation_rate"])
    frac = float(traffic["indel_fraction"])
    return e + r * (1.0 - frac), r * frac, float(traffic["indel_extend"])


def make_pool(genome: torch.Tensor, cover: torch.Tensor, reads: dict,
              traffic: dict, n_batches: int, batch: int,
              gen: torch.Generator) -> Pool:
    """`n_batches` batches of `batch` reads of the configuration's "reads"
    group under a traffic mix."""
    dev = genome.device
    L = int(reads["length"])
    n = n_batches * batch
    sub, indel, extend = rates(traffic)
    region = traffic.get("region", "uniform")
    slack = 0 if indel <= 0 else 16 + int(8 * indel * L / (1.0 - extend))
    if reads.get("paired"):
        P = n // 2
        ins = torch.round(torch.normal(
            float(reads["insert_mean"]), float(reads["insert_sd"]), (P,),
            generator=gen, device=dev)).long().clamp(min=L + 10)
        left = _starts(P, int(ins.max()) + slack, genome, cover, region, gen)
        right = left + ins - L
        swap = _rand(P, gen, dev) < 0.5
        pos = torch.where(swap[:, None], torch.stack([right, left], 1),
                          torch.stack([left, right], 1)).reshape(-1)
        strand = torch.where(swap[:, None],
                             torch.tensor([1, 0], device=dev),
                             torch.tensor([0, 1], device=dev)).reshape(-1)
    else:
        pos = _starts(n, L + slack, genome, cover, region, gen)
        strand = torch.randint(0, 2, (n,), generator=gen, device=dev)
    win = _mutate(_windows(genome, pos, L + slack), sub, gen)
    seq = _indels(win, L, indel, extend, gen)
    codes = torch.where(strand[:, None] == 1, _revcomp(seq), seq)
    return Pool(codes.reshape(n_batches, batch, L).contiguous(),
                torch.full((n_batches, batch), L, dtype=I32, device=dev),
                pos.reshape(n_batches, batch),
                strand.to(I32).reshape(n_batches, batch))
