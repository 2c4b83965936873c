"""FASTA reading (plain or gzip).

Copy of ``nextgenmap_tpu/io/fasta.py``'s reader.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator

import numpy as np

from nextgenmap_tpu_torch.io.encode import encode_seq


def _open_text(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f


def iter_fasta(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (name, uint8 code array) per record. Name is up to first whitespace."""
    name = None
    chunks: list[bytes] = []
    with _open_text(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield name, encode_seq(b"".join(chunks))
                name = line[1:].split()[0].decode("ascii")
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, encode_seq(b"".join(chunks))
