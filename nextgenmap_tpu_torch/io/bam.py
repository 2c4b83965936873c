"""BAM output, and a minimal reader (BAM read input, round-trip tests).

Copy of ``nextgenmap_tpu/io/bam.py``: a self-contained BGZF + BAM encoder
(numpy, zlib and struct; no htslib).  ``BamTextWriter`` is a file-like sink
that takes the exact SAM text the SamWriter emits and encodes it record by
record, so SAM and BAM outputs cannot drift apart.
"""

from __future__ import annotations

import struct
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
_SEQ_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_CIGAR_OP = {c: i for i, c in enumerate("MIDNSHP=X")}

# byte -> 4-bit code LUT (upper+lower case; unknown = N = 15)
_SEQ_LUT = np.full(256, 15, np.uint8)
for _c, _i in _SEQ_CODE.items():
    _SEQ_LUT[ord(_c)] = _i
    _SEQ_LUT[ord(_c.lower())] = _i


def _reg2bin(beg: int, end: int) -> int:
    """UCSC reg2bin (SAM spec section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _deflate_block(payload: bytes) -> bytes:
    """One complete BGZF block for a <=64KB payload (runs on worker threads:
    zlib releases the GIL, so blocks compress in parallel)."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(payload) + co.flush()
    total = len(cdata) + 26  # 18B header + cdata + 8B footer
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
        + struct.pack("<H", total - 1)  # BSIZE = total block size - 1
    )
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    return header + cdata + footer


class BgzfWriter:
    """BGZF: independently-deflated <=64KB blocks with a BSIZE extra field.

    Blocks are independent by construction, so compression fans out over a
    small thread pool while this thread keeps encoding records; completed
    blocks are written strictly in submission order, so the output bytes are
    identical to the serial encoder's."""

    MAX_PENDING = 32

    def __init__(self, raw, threads: int = 4):
        self._raw = raw
        self._buf = bytearray()
        self._pool = ThreadPoolExecutor(max_workers=threads) if threads > 1 else None
        self._pending: deque = deque()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= 0xFF00:
            self._flush_block(bytes(self._buf[:0xFF00]))
            del self._buf[:0xFF00]

    def _flush_block(self, payload: bytes) -> None:
        if self._pool is None:
            self._raw.write(_deflate_block(payload))
            return
        self._pending.append(self._pool.submit(_deflate_block, payload))
        while self._pending and (
            self._pending[0].done() or len(self._pending) > self.MAX_PENDING
        ):
            self._raw.write(self._pending.popleft().result())

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        while self._pending:
            self._raw.write(self._pending.popleft().result())
        if self._pool is not None:
            self._pool.shutdown()
        self._raw.write(_BGZF_EOF)
        self._raw.close()


def _encode_tags(fields: list[str]) -> bytes:
    out = bytearray()
    for tag in fields:
        name, typ, val = tag.split(":", 2)
        out += name.encode()
        if typ == "i":
            out += b"i" + struct.pack("<i", int(val))
        elif typ == "f":
            out += b"f" + struct.pack("<f", float(val))
        elif typ == "A":
            out += b"A" + val.encode()[:1]
        else:  # Z (and anything else as string)
            out += b"Z" + val.encode() + b"\x00"
    return bytes(out)


def encode_record(fields: list[str], ref_ids: dict[str, int]) -> bytes:
    """One SAM text record -> one BAM alignment block (without block_size)."""
    qname, flag, rname, pos1, mapq, cigar, rnext, pnext1, tlen = fields[:9]
    seq, qual = fields[9], fields[10]
    flag = int(flag)
    ref_id = ref_ids.get(rname, -1)
    pos = int(pos1) - 1
    cig = []
    if cigar != "*":
        n = 0
        for ch in cigar:
            if ch.isdigit():
                n = n * 10 + ord(ch) - 48
            else:
                cig.append((n << 4) | _CIGAR_OP[ch])
                n = 0
    if rnext == "=":
        next_ref = ref_id
    else:
        next_ref = ref_ids.get(rnext, -1)
    next_pos = int(pnext1) - 1
    l_seq = 0 if seq == "*" else len(seq)
    ref_span = sum(c >> 4 for c in cig if (c & 15) in (0, 2, 3, 7, 8)) or 1
    name_b = qname.encode() + b"\x00"
    rec = bytearray()
    rec += struct.pack(
        "<iiBBHHHiiii",
        ref_id, pos, len(name_b),
        int(mapq), _reg2bin(max(0, pos), max(0, pos) + ref_span),
        len(cig), flag, l_seq, next_ref, next_pos, int(tlen),
    )
    rec += name_b
    rec += struct.pack(f"<{len(cig)}I", *cig)
    if l_seq:
        # vectorized 4-bit packing (a per-char Python loop here would
        # dominate BAM encoding at millions of reads)
        codes = _SEQ_LUT[np.frombuffer(seq.encode("ascii"), np.uint8)]
        if l_seq % 2:
            codes = np.append(codes, np.uint8(0))
        rec += ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
        if qual == "*":
            rec += b"\xff" * l_seq
        else:
            q = np.frombuffer(qual.encode("ascii"), np.uint8)
            rec += np.minimum(93, q - 33).astype(np.uint8).tobytes()
    rec += _encode_tags(fields[11:])
    return bytes(rec)


class BamTextWriter:
    """File-like SAM-text sink that writes BAM.

    Feed it the same text the SamWriter produces (header first); it encodes
    each record line as one BAM alignment block.
    """

    def __init__(self, path: str):
        self._bgzf = BgzfWriter(open(path, "wb"))
        self._header_lines: list[str] = []
        self._refs: list[tuple[str, int]] = []
        self._ref_ids: dict[str, int] = {}
        self._header_done = False
        self._pending = ""

    def write(self, text: str) -> None:
        self._pending += text
        while "\n" in self._pending:
            line, self._pending = self._pending.split("\n", 1)
            self._line(line)

    def _line(self, line: str) -> None:
        if line.startswith("@"):
            assert not self._header_done, "header line after records"
            self._header_lines.append(line)
            if line.startswith("@SQ"):
                d = dict(
                    f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
                )
                self._ref_ids[d["SN"]] = len(self._refs)
                self._refs.append((d["SN"], int(d["LN"])))
            return
        if not self._header_done:
            self._write_header()
        rec = encode_record(line.rstrip("\n").split("\t"), self._ref_ids)
        self._bgzf.write(struct.pack("<i", len(rec)) + rec)

    def _write_header(self) -> None:
        text = ("\n".join(self._header_lines) + "\n").encode()
        out = b"BAM\x01" + struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(self._refs))
        for name, length in self._refs:
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._bgzf.write(out)
        self._header_done = True

    def close(self) -> None:
        if not self._header_done:
            self._write_header()
        self._bgzf.close()


# ---------------------------------------------------------------------------
# minimal reader (round-trip tests; BAM input support)

def _bgzf_decompress(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        assert data[i : i + 2] == b"\x1f\x8b", "bad BGZF magic"
        xlen = struct.unpack_from("<H", data, i + 10)[0]
        bsize = None
        j = i + 12
        end_extra = j + xlen
        while j < end_extra:
            si1, si2, slen = data[j], data[j + 1], struct.unpack_from("<H", data, j + 2)[0]
            if si1 == 0x42 and si2 == 0x43:
                bsize = struct.unpack_from("<H", data, j + 4)[0] + 1
            j += 4 + slen
        assert bsize is not None, "missing BSIZE"
        cdata = data[end_extra : i + bsize - 8]
        out += zlib.decompress(cdata, -15)
        i += bsize
    return bytes(out)


def read_bam(path: str):
    """Parse a BAM file -> (header_text, refs, records as SAM-field lists)."""
    raw = _bgzf_decompress(open(path, "rb").read())
    assert raw[:4] == b"BAM\x01"
    l_text = struct.unpack_from("<i", raw, 4)[0]
    text = raw[8 : 8 + l_text].decode()
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", raw, off)[0]
        name = raw[off + 4 : off + 4 + ln - 1].decode()
        length = struct.unpack_from("<i", raw, off + 4 + ln)[0]
        refs.append((name, length))
        off += 8 + ln
    recs = []
    seq_chars = "=ACMGRSVTWYHKDBN"
    cigar_ops = "MIDNSHP=X"
    while off < len(raw):
        bs = struct.unpack_from("<i", raw, off)[0]
        body = raw[off + 4 : off + 4 + bs]
        off += 4 + bs
        (ref_id, pos, l_name, mapq, _bin, n_cig, flag, l_seq,
         next_ref, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", body)
        p = 32
        qname = body[p : p + l_name - 1].decode()
        p += l_name
        cig = struct.unpack_from(f"<{n_cig}I", body, p)
        p += 4 * n_cig
        seq = ""
        for i in range(l_seq):
            b = body[p + i // 2]
            seq += seq_chars[(b >> 4) if i % 2 == 0 else (b & 15)]
        p += (l_seq + 1) // 2
        qual = bytes(body[p : p + l_seq])
        p += l_seq
        cigar = "".join(f"{c >> 4}{cigar_ops[c & 15]}" for c in cig) or "*"
        rname = refs[ref_id][0] if ref_id >= 0 else "*"
        rnext = refs[next_ref][0] if next_ref >= 0 else "*"
        recs.append([
            qname, str(flag), rname, str(pos + 1), str(mapq), cigar,
            "=" if (rnext == rname and next_ref >= 0) else rnext,
            str(next_pos + 1), str(tlen),
            seq if l_seq else "*",
            "*" if (not l_seq or qual[:1] == b"\xff")
            else "".join(chr(q + 33) for q in qual),
        ])
    return text, refs, recs
