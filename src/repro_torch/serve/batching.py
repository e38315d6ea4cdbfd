"""Geometry-bucketed request micro-batching for the predict server (the
port of ``repro.serve.batching``).

The plan-cache contract (``core.plan``) keys cached runs by leaf
GEOMETRY — shape, block grid, dtype, pad state, and (for BCOO) stored-entry
capacity — never by data.  Serving therefore gets zero-recompile
steady-state for free *iff* every dispatched batch lands on one of a small
declared set of geometries.  This module is that quantization:

* a :class:`BucketSpec` declares, per model, the batch-row buckets (and for
  sparse inputs the per-block ``nse`` capacity) predict plans are AOT-warmed
  for at model-load time;
* :func:`assemble` concatenates queued request payloads, pads the tail rows
  with zeros up to the chosen bucket — ``from_array``/``from_scipy`` then
  construct the block tensor with the usual zero edge padding, so the
  result carries ``PAD_ZERO`` and dispatch stays on the fused path — and
  returns a ds-array of EXACTLY the bucket's geometry;
* :func:`split_rows` slices the ``(bucket_rows, 1)`` result back into
  per-request row groups (pad rows are simply dropped).

Exactness note: padding and result-slicing are bitwise-neutral — each
request's served rows are EXACTLY the corresponding rows of
``estimator.predict`` on the padded bucket batch (same cached run, same
kernels at the same geometry, same values; pad rows only add exact +0.0
terms).  Equality with a direct predict of the same rows at a DIFFERENT
geometry is a separate, weaker property: the GEMM kernel's tiling and
split-K choice can vary with the block shape, so it is structural only
when the geometries coincide — which is why ``1`` belongs in
``batch_sizes``: a lone request then serves at its natural ``(1, m)``
geometry, the exact run a direct single-row ``predict`` takes.  Stacked
COO batches are geometry-stable either way (per-row sums in entry order).

Every batch is built on the device its bucket names (``device=``, default
``"cuda"``; the tests pass ``"cpu"``).

Dense payloads are NumPy ``(r, m)`` arrays; sparse payloads are
scipy.sparse matrices and stay sparse end-to-end (``scipy.sparse.vstack``
-> :func:`repro_torch.core.sparse.from_scipy` at the bucket's fixed ``nse`` —
no densification anywhere).  A batch whose densest block exceeds the
declared ``nse`` capacity must NOT be packed (entries would truncate):
``assemble`` returns ``None`` and the server falls back to unbatched
predicts at natural geometry.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import sparse as _sparse
from repro_torch.core.dsarray import DsArray, from_array

FORMAT_DENSE = "dense"
FORMAT_BCOO = "bcoo"

#: default block-row size for bucketed batches — matches the
#: ``BaseEstimator._validate_x`` convention so served and direct predicts
#: share column blocking (one column block of all m features) and differ
#: only in the row count, which per-row ops never observe.
DEFAULT_BLOCK_ROWS = 128


@dataclasses.dataclass(frozen=True)
class GeometryBucket:
    """One declared input geometry: the static half of a predict plan key."""

    rows: int                 # padded batch rows (the plan's n)
    block_rows: int           # row blocking of the batch dimension
    n_features: int
    fmt: str                  # "dense" | "bcoo"
    dtype: str = "float32"
    nse: Optional[int] = None  # bcoo: stored entries per block (capacity)
    device: str = "cuda"       # where the batch is built

    def __post_init__(self):
        if self.fmt not in (FORMAT_DENSE, FORMAT_BCOO):
            raise ValueError(f"unknown block format {self.fmt!r}")
        if self.fmt == FORMAT_BCOO and self.nse is None:
            raise ValueError("bcoo buckets need an explicit nse capacity")


class BucketSpec:
    """The declared serving geometries for one model.

    ``batch_sizes`` are the padded batch-row buckets (ascending);
    ``formats`` selects which block formats get warmed plans.  ``nse`` is
    the per-block stored-entry capacity for bcoo buckets — declare it from
    the expected request density (e.g. ``ceil(block_rows * n_features *
    max_density)``); denser batches fall back to unbatched predict.
    """

    def __init__(self, n_features: int,
                 batch_sizes: Sequence[int] = (1, 8, 32),
                 formats: Sequence[str] = (FORMAT_DENSE,),
                 block_rows: Optional[int] = None,
                 dtype: str = "float32",
                 nse: Optional[int] = None,
                 device: str = "cuda"):
        if not batch_sizes:
            raise ValueError("need at least one batch-size bucket")
        if any(b <= 0 for b in batch_sizes):
            raise ValueError(f"batch sizes must be positive: {batch_sizes}")
        self.n_features = int(n_features)
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        self.formats = tuple(formats)
        self.block_rows = block_rows
        self.dtype = dtype
        self.nse = nse
        self.device = str(device)
        for f in self.formats:
            if f not in (FORMAT_DENSE, FORMAT_BCOO):
                raise ValueError(f"unknown block format {f!r}")
        if FORMAT_BCOO in self.formats and nse is None:
            raise ValueError("serving bcoo inputs needs an nse= capacity")

    def _bucket(self, rows: int, fmt: str) -> GeometryBucket:
        br = self.block_rows if self.block_rows is not None \
            else min(rows, DEFAULT_BLOCK_ROWS)
        return GeometryBucket(rows=rows, block_rows=min(br, rows),
                              n_features=self.n_features, fmt=fmt,
                              dtype=self.dtype,
                              nse=self.nse if fmt == FORMAT_BCOO else None,
                              device=self.device)

    def buckets(self) -> List[GeometryBucket]:
        """Every declared geometry (format x batch size) — the warm set."""
        return [self._bucket(b, f) for f in self.formats
                for b in self.batch_sizes]

    def bucket_for(self, rows: int, fmt: str) -> Optional[GeometryBucket]:
        """Smallest declared bucket holding ``rows`` rows of ``fmt`` input
        (the tail-padding target), or None when out of the declared range."""
        if fmt not in self.formats or rows <= 0:
            return None
        for b in self.batch_sizes:
            if rows <= b:
                return self._bucket(b, fmt)
        return None

    def max_rows(self, fmt: str) -> int:
        return self.batch_sizes[-1] if fmt in self.formats else 0


# ---------------------------------------------------------------------------
# Payload normalization
# ---------------------------------------------------------------------------


def payload_format(payload) -> str:
    """``"bcoo"`` for scipy.sparse payloads, ``"dense"`` for array-likes."""
    return FORMAT_BCOO if hasattr(payload, "tocoo") else FORMAT_DENSE


def normalize_payload(payload, n_features: int) -> Tuple[object, int, str]:
    """Validate one request payload -> ``(payload, n_rows, fmt)``.

    Dense: any array-like coerced to a NumPy ``(r, m)`` (a 1-D vector is
    one row).  Sparse: a scipy.sparse matrix, kept sparse.  The feature
    count must match the model's declared geometry — a mismatched request
    fails at submit, not deep inside a batch.
    """
    if payload_format(payload) == FORMAT_BCOO:
        if payload.shape[1] != n_features:
            raise ValueError(
                f"request has {payload.shape[1]} features, model serves "
                f"{n_features}")
        if payload.shape[0] < 1:
            raise ValueError("empty request (0 rows)")
        return payload, int(payload.shape[0]), FORMAT_BCOO
    arr = np.asarray(payload)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    if arr.ndim != 2 or arr.shape[1] != n_features:
        raise ValueError(
            f"request shape {arr.shape} does not match (r, {n_features})")
    if arr.shape[0] < 1:
        raise ValueError("empty request (0 rows)")
    return arr, int(arr.shape[0]), FORMAT_DENSE


# ---------------------------------------------------------------------------
# Batch assembly / result splitting
# ---------------------------------------------------------------------------


def representative_input(bucket: GeometryBucket) -> DsArray:
    """An all-zero ds-array of exactly the bucket's geometry — what the
    compile cache records + AOT-compiles the predict plan on at warm time.
    Plan keys never include leaf data, so the zero warm input and every
    real request batch share one cached run."""
    if bucket.fmt == FORMAT_DENSE:
        z = np.zeros((bucket.rows, bucket.n_features), dtype=bucket.dtype)
        return from_array(z, (bucket.block_rows, bucket.n_features),
                          device=bucket.device)
    import scipy.sparse as sp
    empty = sp.csr_matrix((bucket.rows, bucket.n_features),
                          dtype=np.dtype(bucket.dtype))
    return _sparse.from_scipy(empty, (bucket.block_rows, bucket.n_features),
                              nse=bucket.nse, device=bucket.device)


def assemble(payloads: Sequence, bucket: GeometryBucket) -> Optional[DsArray]:
    """Concatenate request payloads, pad the tail to the bucket's rows, and
    build the ds-array at the bucket's exact geometry.  Returns None when a
    bcoo batch's densest block exceeds the bucket's ``nse`` capacity (the
    caller falls back; packing would silently drop entries)."""
    total = sum(int(p.shape[0]) for p in payloads)
    if total > bucket.rows:
        raise ValueError(f"{total} rows exceed the {bucket.rows}-row bucket")
    pad = bucket.rows - total
    dt = np.dtype(bucket.dtype)
    if bucket.fmt == FORMAT_DENSE:
        parts = [np.asarray(p, dtype=dt) for p in payloads]
        if pad:
            parts.append(np.zeros((pad, bucket.n_features), dtype=dt))
        batch = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        return from_array(batch, (bucket.block_rows, bucket.n_features),
                          device=bucket.device)
    import scipy.sparse as sp
    mats = [p.astype(dt, copy=False) for p in payloads]
    if pad:
        mats.append(sp.csr_matrix((pad, bucket.n_features), dtype=dt))
    batch = mats[0] if len(mats) == 1 else sp.vstack(mats)
    shape = (bucket.block_rows, bucket.n_features)
    if _sparse.max_block_nnz(batch, shape) > bucket.nse:
        return None
    # capacity just verified above — skip from_scipy's own overflow guard
    return _sparse.from_scipy(batch, shape, nse=bucket.nse, check_nse=False,
                              device=bucket.device)


def split_rows(rows: np.ndarray, sizes: Sequence[int]) -> List[np.ndarray]:
    """Slice the collected ``(bucket_rows, 1)`` prediction column back into
    per-request results; trailing pad rows fall off the end."""
    out, off = [], 0
    for s in sizes:
        out.append(np.asarray(rows[off:off + s]))
        off += s
    return out
