"""Byte-range file chunking + per-format line parsers (paper §4.2.2).

The streaming loaders in :mod:`repro_torch.core.io` never hold more than one
chunk of raw text plus one block-row of parsed values on the host.  The
primitive that makes this safe is the dask ``bytes/core.py`` idiom: a byte
range ``[offset, offset + length)`` is grown to line boundaries by seeking
to the first line *start* at or after each end.  Because a line starts at
byte 0 or immediately after a delimiter, successive ranges tile the file
into whole-line chunks with no gaps, overlaps, or split records — the same
property lets independent hosts each read only their own shard's ranges.

Parsers are per-format and chunk-local: they return NumPy arrays (text) or
COO triplets with chunk-local row ids (svmlight), never touching global
state, so the loaders own all assembly and the memory accounting.
"""

from __future__ import annotations

import io as _io
from typing import Iterator, Optional, Tuple

import numpy as np

#: Default raw-text chunk size for the streaming loaders.  Small enough that
#: chunk + parsed values stay well under one block-row of a realistic
#: geometry; callers with big block rows can raise it to amortize parse
#: overhead (each chunk is one ``np.loadtxt`` / one Python line loop).
DEFAULT_CHUNK_BYTES = 1 << 16


def next_line_start(f, pos: int, delimiter: bytes = b"\n",
                    blocksize: int = 1 << 16) -> int:
    """Offset of the first line START at or after ``pos``.

    ``pos == 0`` is always a line start.  Otherwise scan forward from
    ``pos - 1`` for a delimiter — if the byte just before ``pos`` is one,
    the line starting exactly at ``pos`` is found (this is what makes the
    tiling gap-free).  Returns EOF when no further line starts.
    """
    if pos <= 0:
        return 0
    f.seek(pos - 1)
    while True:
        buf = f.read(blocksize)
        if not buf:
            return f.tell()
        i = buf.find(delimiter)
        if i >= 0:
            return f.tell() - len(buf) + i + len(delimiter)


def read_block(f, offset: int, length: int,
               delimiter: bytes = b"\n") -> bytes:
    """Bytes of every line that STARTS in ``[offset, offset + length)``.

    Both ends are advanced to the next line start (dask ``read_block``),
    so the returned bytes are whole lines; the final block of a file with
    no trailing newline runs to EOF.  Empty when no line starts in range.
    """
    start = next_line_start(f, offset, delimiter)
    end = next_line_start(f, offset + length, delimiter)
    if end <= start:
        return b""
    f.seek(start)
    return f.read(end - start)


def iter_line_chunks(path: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                     delimiter: bytes = b"\n") -> Iterator[bytes]:
    """Successive whole-line chunks of ``path``, each ~``chunk_bytes`` long
    (plus at most one line).  Union of chunks == file, each line exactly
    once — the sequential view of the per-host byte-range read."""
    chunk_bytes = max(1, int(chunk_bytes))
    with open(path, "rb") as f:
        f.seek(0, _io.SEEK_END)
        size = f.tell()
        for off in range(0, size, chunk_bytes):
            chunk = read_block(f, off, chunk_bytes, delimiter)
            if chunk:
                yield chunk


def parse_txt_chunk(chunk: bytes, delimiter: str = ",",
                    dtype=np.float32) -> Optional[np.ndarray]:
    """Whole-line text chunk -> ``(k, m)`` array (None if only blank lines).

    CRLF endings are normalized before the parse; blank lines (including an
    empty trailing line) contribute no rows.
    """
    if b"\r" in chunk:                      # only CRLF files pay the copy
        chunk = chunk.replace(b"\r\n", b"\n")
    if not chunk.strip():
        return None
    arr = np.loadtxt(_io.BytesIO(chunk), delimiter=delimiter, dtype=dtype,
                     ndmin=2)
    return arr if arr.size else None


def parse_svmlight_chunk(chunk: bytes, dtype=np.float32,
                         zero_based: bool = False,
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
    """Whole-line svmlight chunk -> ``(labels, rows, cols, vals)``.

    ``rows`` are chunk-local (0..k-1, one id per non-blank line, sorted
    non-decreasing), ``cols`` are global feature ids already shifted to
    0-based when ``zero_based=False`` (the svmlight convention: features
    count from 1).  Per-line ``#`` comments and ``qid:`` fields are
    dropped.  Memory stays compact: Python token lists live one line at a
    time; per-line triplets accumulate as small NumPy arrays.
    """
    labels = []
    row_parts, col_parts, val_parts = [], [], []
    shift = 0 if zero_based else 1
    if b"\r" in chunk:                      # only CRLF files pay the copy
        chunk = chunk.replace(b"\r\n", b"\n")
    for ln in chunk.split(b"\n"):
        hash_pos = ln.find(b"#")
        if hash_pos >= 0:
            ln = ln[:hash_pos]
        toks = ln.split()
        if not toks:
            continue
        r = len(labels)
        labels.append(float(toks[0]))
        cols, vals = [], []
        for t in toks[1:]:
            k, _, v = t.partition(b":")
            if k == b"qid":
                continue
            c = int(k) - shift
            if c < 0:
                raise ValueError(
                    f"svmlight feature id {int(k)} underflows with "
                    f"zero_based={zero_based} (1-based files count from 1; "
                    f"pass zero_based=True for 0-based files)")
            cols.append(c)
            vals.append(float(v))
        if cols:
            row_parts.append(np.full(len(cols), r, dtype=np.int32))
            col_parts.append(np.asarray(cols, dtype=np.int32))
            val_parts.append(np.asarray(vals, dtype=dtype))
    if row_parts:
        rows = np.concatenate(row_parts)
        cols = np.concatenate(col_parts)
        vals = np.concatenate(val_parts)
    else:
        rows = np.empty(0, np.int32)
        cols = np.empty(0, np.int32)
        vals = np.empty(0, dtype)
    return (np.asarray(labels, dtype=dtype), rows, cols, vals)
