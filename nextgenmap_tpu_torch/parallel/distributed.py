"""Mapping across processes: read sharding by batch and the ordered merge.

Port of ``nextgenmap_tpu/parallel/distributed.py``.  Read mapping is
embarrassingly parallel over reads:

- Every process streams the same input but maps only the batches whose
  index is its process id modulo the process count (``shard_batches``), so
  the hot path needs no coordination and any process count gives the same
  per-read results.
- Each process writes its records to ``<out>.part<i>-of-<n>`` and a
  manifest of per-batch line and byte counts; process 0's merge
  interleaves the parts' batch runs round-robin back into the exact
  single-process output (DESIGN.md rule 14).
- Within a process the batch may still split over several devices
  (``parallel/dp.py``).  Collectives are needed only when the INDEX is
  split across processes (``--shard-across-hosts``,
  ``parallel/index_shard.py::ShardExchange``); ``init_distributed`` brings
  up the torch.distributed group they run in (gloo, host tensors).
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import IO, Iterator

from nextgenmap_tpu_torch.utils.logging import get_logger

log = get_logger("ngm-torch.dist")

# how long a process waits for its peers, at the rendezvous and in each
# collective; a peer that exits ends the wait at once (its sockets close)
DIST_TIMEOUT_S = 1800
# how long process 0's merge waits for the other parts' manifests
MERGE_TIMEOUT_S = 3600


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Join the torch.distributed group (gloo) of `num_processes`
    processes at `coordinator` (host:port; process 0 listens there)."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S),
    )
    log.info("torch.distributed up: process %d/%d (gloo)", process_id,
             num_processes)


def shutdown_distributed() -> None:
    """Leave the group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batches(batches: Iterator, procid: int, nprocs: int) -> Iterator:
    """Yield only the batches owned by this process (round-robin by index)."""
    for i, b in enumerate(batches):
        if i % nprocs == procid:
            yield b


def part_path(out_path: str, procid: int, nprocs: int) -> str:
    return f"{out_path}.part{procid}-of-{nprocs}"


def manifest_path(out_path: str, procid: int, nprocs: int) -> str:
    return part_path(out_path, procid, nprocs) + ".manifest.json"


class CountingWriter:
    """Text-stream wrapper counting emitted lines AND bytes (records are one
    line; byte counts let the merge copy a batch's run with one read)."""

    def __init__(self, out: IO[str], lines: int = 0, nbytes: int = 0):
        self.out = out
        self.lines = lines
        self.nbytes = nbytes

    def write(self, s: str) -> int:
        self.lines += s.count("\n")
        self.nbytes += len(s)
        return self.out.write(s)

    def flush(self) -> None:
        self.out.flush()

    def close(self) -> None:
        self.out.close()


def write_manifest(out_path: str, procid: int, nprocs: int,
                   header_lines: int, batch_lines: list[int],
                   stats_dict: dict, complete: bool,
                   batch_bytes: list[int] | None = None) -> None:
    mp = manifest_path(out_path, procid, nprocs)
    tmp = mp + ".tmp"
    with open(tmp, "w") as f:
        json.dump({
            "procid": procid, "nprocs": nprocs,
            "header_lines": header_lines,
            "batch_lines": batch_lines,
            "batch_bytes": batch_bytes,
            "stats": stats_dict,
            "complete": complete,
        }, f)
    os.replace(tmp, mp)


def _wait_for_manifests(out_path: str, nprocs: int,
                        timeout: float) -> list[dict]:
    """Poll until every part's manifest exists and is complete."""
    deadline = time.time() + timeout
    manifests: list[dict | None] = [None] * nprocs
    while True:
        for i in range(nprocs):
            if manifests[i] is not None:
                continue
            mp = manifest_path(out_path, i, nprocs)
            if os.path.exists(mp):
                try:
                    with open(mp) as f:
                        m = json.load(f)
                except (OSError, ValueError):
                    continue
                if m.get("complete"):
                    manifests[i] = m
        if all(m is not None for m in manifests):
            return manifests  # type: ignore[return-value]
        if time.time() > deadline:
            missing = [i for i, m in enumerate(manifests) if m is None]
            raise TimeoutError(
                f"timed out waiting for output shards {missing} of {out_path}")
        time.sleep(0.5)


def merge_parts(out_path: str, nprocs: int, bam: bool = False) -> dict:
    """Merge ``<out>.part*`` into ``out_path``, restoring input read order.

    Batch b went to process b % nprocs, so the merge interleaves the parts'
    per-batch runs in that order, each as one bulk copy of its byte count.
    With bam=True the merged text is encoded through the port's
    BamTextWriter (parts are always SAM text).  Returns the summed stats.
    Runs on process 0 once every manifest reports complete (a shared
    filesystem is assumed), and removes the parts."""
    manifests = _wait_for_manifests(out_path, nprocs, MERGE_TIMEOUT_S)
    parts = [open(part_path(out_path, i, nprocs), "r", buffering=1 << 20)
             for i in range(nprocs)]
    if bam:
        from nextgenmap_tpu_torch.io.bam import BamTextWriter

        out = BamTextWriter(out_path)
    else:
        out = open(out_path, "w", buffering=1 << 20)
    try:
        # the header comes from part 0; the other parts' are skipped
        for i, (m, f) in enumerate(zip(manifests, parts)):
            for _ in range(m["header_lines"]):
                line = f.readline()
                if i == 0:
                    out.write(line)
        sizes = [m["batch_bytes"] for m in manifests]
        cursor = [0] * nprocs
        b = 0
        while True:
            p = b % nprocs
            if cursor[p] >= len(sizes[p]):
                # the global batch sequence ends at the first missing owner
                break
            out.write(parts[p].read(sizes[p][cursor[p]]))
            cursor[p] += 1
            b += 1
    finally:
        for f in parts:
            f.close()
        out.close()
    totals: dict = {}
    for m in manifests:
        for k, v in m["stats"].items():
            if isinstance(v, (int, float)):
                totals[k] = totals.get(k, 0) + v
    for i in range(nprocs):
        os.remove(part_path(out_path, i, nprocs))
        os.remove(manifest_path(out_path, i, nprocs))
    log.info("merged %d output shards into %s", nprocs, out_path)
    return totals
