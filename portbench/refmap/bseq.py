"""FASTA/FASTQ reading (kseq-compatible semantics).

Mirrors kseq.h parsing: record name is the first whitespace-delimited
token after '>'/'@', the rest of the header line is the comment,
sequence lines are concatenated; FASTQ quality is parsed and discarded.
Transparent gzip support.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator


@dataclass
class Seq1:
    name: str
    seq: bytes
    comment: str | None = None


def _open_maybe_gzip(fn: str) -> io.BufferedReader:
    f = open(fn, "rb")
    magic = f.peek(2)[:2]
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))  # type: ignore[arg-type]
    return f


def _split_hdr(hdr: bytes):
    sp = -1
    for i, ch in enumerate(hdr):
        if ch in (0x20, 0x09):
            sp = i
            break
    if sp < 0:
        return hdr.decode(), None
    return hdr[:sp].decode(), (hdr[sp + 1:].strip().decode() or None)


def iter_fasta_spans(data: bytes):
    """Yield (header_bytes, body_start, body_end) spans over an
    in-memory '>'-led FASTA buffer.  The body span [start, end) still
    contains newlines; a header-only final record without a trailing
    newline yields an empty span.  This is the single home of the
    record-boundary rules (header split point, the ``\\n>`` scan, the
    header-only-EOF edge) shared by read_fasta_all and
    genome.NtDB.from_fasta."""
    pos = data.find(b">")
    while pos >= 0:
        hdr_end = data.find(b"\n", pos)
        if hdr_end < 0:  # header-only final record without newline
            yield data[pos + 1:].rstrip(b"\r"), len(data), len(data)
            return
        nxt = data.find(b"\n>", hdr_end)
        body_end = len(data) if nxt < 0 else nxt + 1
        yield data[pos + 1:hdr_end].rstrip(b"\r"), hdr_end + 1, body_end
        pos = -1 if nxt < 0 else nxt + 1


def read_fasta_all(fn: str) -> list[Seq1]:
    """Whole-file FASTA reader: the fast path for genome loading (the
    streaming parser costs ~20ns/byte in Python; this is one read + two
    C-speed scans per record).  Falls back to the streaming parser for
    FASTQ or unusual layouts."""
    with _open_maybe_gzip(fn) as f:
        head = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if head != b">":
            return list(read_fastx(fn))
        data = f.read()
    out = []
    for hdr, body_s, body_e in iter_fasta_spans(data):
        name, comment = _split_hdr(hdr)
        seq = data[body_s:body_e].replace(b"\n", b"")
        if b"\r" in seq:
            seq = seq.replace(b"\r", b"")
        out.append(Seq1(name, seq, comment))
    return out


def read_fastx(fn: str) -> Iterator[Seq1]:
    """Stream records from a (possibly gzipped) FASTA/FASTQ file."""
    with _open_maybe_gzip(fn) as f:
        name = None
        comment: str | None = None
        chunks: list[bytes] = []
        is_fastq = False
        line_iter = iter(f)
        for raw in line_iter:
            line = raw.rstrip(b"\r\n")
            if not line and name is None:
                continue
            if line[:1] in (b">", b"@"):
                if name is not None:
                    yield Seq1(name, b"".join(chunks), comment)
                hdr = line[1:]
                sp = -1
                for i, ch in enumerate(hdr):
                    if ch in (0x20, 0x09):  # space or tab
                        sp = i
                        break
                if sp < 0:
                    name, comment = hdr.decode(), None
                else:
                    name = hdr[:sp].decode()
                    comment = hdr[sp + 1:].strip().decode() or None
                chunks = []
                is_fastq = line[:1] == b"@"
            elif line[:1] == b"+" and is_fastq:
                # consume quality lines of equal total length
                qlen, slen = 0, sum(len(c) for c in chunks)
                while qlen < slen:
                    qraw = next(line_iter, None)
                    if qraw is None:
                        break
                    qlen += len(qraw.rstrip(b"\r\n"))
                yield Seq1(name, b"".join(chunks), comment)
                name, comment, chunks, is_fastq = None, None, [], False
            elif name is not None:
                chunks.append(line)
        if name is not None:
            yield Seq1(name, b"".join(chunks), comment)


