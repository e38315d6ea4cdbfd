"""Checkpoints with atomic commit and async save (the port of
``repro.checkpoint.checkpoint``), in the reference's on-disk layout, byte
for byte::

    <root>/step_00000100.tmp/     # written first
        manifest.json             # tree paths, shapes, dtypes, step, extra
        leaf_00000.npy ...        # one file per tree leaf
    <root>/step_00000100/         # atomic rename == commit

A checkpoint written by either package restores in the other.  The tree is
nested dicts (keys in sorted order; an ``OrderedDict`` in its own order),
lists and tuples (by index; a namedtuple by ``.field``), with ``None`` an
empty subtree, as ``jax.tree_util`` flattens it, and each leaf's path is
the ``/``-joined keys the reference writes.

Leaves: a torch tensor is copied to the host and, as every device array of
the reference is 32-bit, a 64-bit one is narrowed first (float64 ->
float32, int64 -> int32); a bfloat16 tensor is written as the reference
writes one (raw 2-byte records, ``<V2`` in the file, ``bfloat16`` in the
manifest), so its own ``restore`` refuses it as the reference's does.
NumPy arrays and Python scalars are written as they are.  A DTensor leaf
(placed on a mesh) is gathered and written whole, by rank 0, as the
reference writes a sharded leaf.  ``restore`` places every leaf on
``device`` (default ``"cuda"``) as a tensor, 64-bit values narrowed as the
reference's ``jnp.asarray`` narrows them; with ``shardings`` (the
reference's elastic path) a leaf with a ``distributed.sharding.Sharding``
lands on that mesh as a DTensor, whatever mesh it was saved from.

``AsyncCheckpointer`` copies the tree to host memory synchronously (a
blocking device-to-host copy: the writer thread must never read a buffer a
later kernel may still overwrite) and writes it in a background thread.
A tree placed on a mesh is gathered on the calling thread of every rank
(a collective), only rank 0 starts a writer, and ``wait()`` ends at a
barrier of all ranks, so no rank reads a checkpoint rank 0 has not
committed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._faults import fire as _fire
from repro_torch.core import placement as _pl

Params = Any

#: the reference's 32-bit rule for device arrays (jnp.asarray without x64)
_NARROW_NP = {np.dtype(np.float64): np.dtype(np.float32),
              np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.uint64): np.dtype(np.uint32),
              np.dtype(np.complex128): np.dtype(np.complex64)}
_NARROW_TORCH = {torch.float64: torch.float32, torch.int64: torch.int32,
                 torch.complex128: torch.complex64}
_BF16 = "bfloat16"


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed; raised from ``wait()`` / the
    next ``save()`` on the calling thread (``__cause__`` is the original)."""


class _BF16Leaf:
    """A bfloat16 leaf on the host: its raw 2-byte records."""

    __slots__ = ("raw",)

    def __init__(self, raw: np.ndarray):
        self.raw = raw                     # uint16, the tensor's shape


def _flatten_with_paths(tree) -> Tuple[List[str], List[Any], Callable]:
    """(paths, leaves, unflatten) in ``jax.tree_util``'s order."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(node, prefix: Tuple[str, ...]):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = list(node) if isinstance(node, OrderedDict) else sorted(node)
            return ("dict", type(node), keys,
                    [walk(node[k], prefix + (str(k),)) for k in keys])
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return ("named", type(node),
                    [walk(v, prefix + (f".{f}",))
                     for f, v in zip(node._fields, node)])
        if isinstance(node, (list, tuple)):
            return ("seq", type(node),
                    [walk(v, prefix + (str(i),)) for i, v in enumerate(node)])
        paths.append("/".join(prefix))
        leaves.append(node)
        return ("leaf",)

    spec = walk(tree, ())

    def unflatten(values):
        it = iter(values)

        def build(s):
            kind = s[0]
            if kind == "none":
                return None
            if kind == "leaf":
                return next(it)
            if kind == "dict":
                return s[1]((k, build(c)) for k, c in zip(s[2], s[3]))
            if kind == "named":
                return s[1](*[build(c) for c in s[2]])
            return s[1](build(c) for c in s[2])

        return build(spec)

    return paths, leaves, unflatten


def _host_leaf(leaf):
    """A leaf as the host value ``save`` writes (see the module docstring);
    a DTensor leaf whole, gathered on every rank (a collective call)."""
    if isinstance(leaf, _BF16Leaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = _pl.gather(leaf.detach())
        if t.dtype == torch.bfloat16:
            return _BF16Leaf(t.to("cpu", copy=True).view(torch.int16)
                             .numpy().view(np.uint16))
        # a copy even on the CPU: the snapshot must not follow later
        # in-place writes to the tensor
        return t.to(device="cpu", dtype=_NARROW_TORCH.get(t.dtype, t.dtype),
                    copy=True).numpy()
    return np.asarray(leaf)


def _write_leaf(path: str, arr) -> Tuple[List[int], str]:
    """Write one host leaf as ``np.save`` would; returns (shape, dtype name)."""
    if isinstance(arr, _BF16Leaf):
        raw = np.ascontiguousarray(arr.raw)
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": raw.shape})
            f.write(raw.tobytes())
        return list(raw.shape), _BF16
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def save(root: str, step: int, tree: Params,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous checkpoint write with atomic commit.  With DTensor
    leaves (a tree placed on a mesh) every rank calls it: each leaf is
    gathered whole on every rank, rank 0 writes and commits, and all ranks
    meet at a barrier before returning."""
    paths, leaves, _ = _flatten_with_paths(tree)
    placed = any(_pl.is_dtensor(leaf) for leaf in leaves)
    if placed:
        import torch.distributed as dist
        writer = dist.get_rank() == 0
    else:
        writer = True
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        fname = f"leaf_{i:05d}.npy"
        host = _host_leaf(leaf)
        if not writer:
            continue
        shape, dtype = _write_leaf(os.path.join(tmp, fname), host)
        manifest["leaves"].append({
            "path": p, "file": fname, "shape": shape, "dtype": dtype,
            "shards": 1,
        })
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # commit
    if placed:
        dist.barrier()
    return final


def list_steps(root: str) -> List[int]:
    """All committed steps in ``root``, ascending.  Only fully committed
    checkpoints count (a ``.tmp`` dir from a crashed writer is invisible):
    a model directory's ``save_model`` versions are its steps."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(root, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def _dtype_name(proto) -> str:
    """The NumPy name of a restore proto's dtype (``bfloat16`` for a
    bfloat16 tensor, which NumPy cannot hold)."""
    dt = proto.dtype
    if isinstance(dt, torch.dtype):
        if dt == torch.bfloat16:
            return _BF16
        return str(torch.empty(0, dtype=dt).numpy().dtype)
    return str(np.dtype(dt))


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A restored host array as a tensor on ``device``, 64-bit narrowed."""
    arr = arr.astype(_NARROW_NP.get(arr.dtype, arr.dtype), copy=False)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _load_leaf(path: str, p: str, proto, allow_cast: bool, dev) -> torch.Tensor:
    """The leaf file ``path`` (tree path ``p``) checked against its proto
    and placed on ``dev`` (see :func:`restore`)."""
    arr = np.load(path)
    if list(arr.shape) != list(proto.shape):
        raise ValueError(f"shape mismatch for {p}: {arr.shape} vs "
                         f"{tuple(proto.shape)}")
    want = _dtype_name(proto)
    if str(arr.dtype) != want:
        if not allow_cast:
            raise ValueError(
                f"dtype mismatch for {p}: checkpoint has {arr.dtype}, "
                f"restore target wants {want} (pass allow_cast=True to "
                f"cast explicitly)")
        if want == _BF16:
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                # the reference's bfloat16 records: reinterpret them
                t = torch.from_numpy(arr.view(np.int16).copy()) \
                    .view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(arr)) \
                    .to(torch.bfloat16)
            return t.to(dev)
        arr = arr.astype(np.dtype(want))
    return _to_device(arr, dev)


def restore(root: str, step: int, like: Params, shardings: Optional[Params] = None,
            device="cuda", allow_cast: bool = False) -> Params:
    """Restore into the structure of ``like`` (tensors, arrays, DTensors or
    ``meta`` tensors as protos), every leaf a tensor on ``device``.

    ``shardings``, a tree of ``like``'s structure with a
    ``distributed.sharding.Sharding`` or ``None`` per leaf, places each
    leaf that has one on its mesh (on the mesh's device): every rank of it
    reads the whole leaf and keeps its own shard, so the mesh the
    checkpoint was saved from does not matter (elastic resharding).

    A dtype mismatch between a saved leaf and its ``like`` proto raises,
    as shape mismatches do: a silent cast would turn a float64-trained
    model restored into a float32 program into a precision loss nobody
    asked for.  ``allow_cast=True`` casts explicitly.
    """
    from repro_torch.core.dsarray import resolve_device
    dev = resolve_device(device)
    _fire("io_load", source="checkpoint", step=step)
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    paths, like_leaves, unflatten = _flatten_with_paths(like)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    if shardings is None:
        shard_leaves = [None] * len(like_leaves)
    else:
        from repro_torch.distributed.sharding import spec_tree_paths
        shard_leaves = spec_tree_paths(shardings)[1]
        if len(shard_leaves) != len(like_leaves):
            raise ValueError(f"{len(shard_leaves)} shardings for "
                             f"{len(like_leaves)} leaves")
    out = []
    for p, proto, sh in zip(paths, like_leaves, shard_leaves):
        entry = by_path.get(p)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {p}")
        t = _load_leaf(os.path.join(d, entry["file"]), p, proto, allow_cast,
                       dev if sh is None else resolve_device(sh.mesh.device_type))
        out.append(t if sh is None else sh.place(t))
    return unflatten(out)


def manifest_extra(root: str, step: int) -> Dict[str, Any]:
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)["extra"]


class AsyncCheckpointer:
    """Snapshot-on-call, write-in-background.  ``wait()`` joins the writer
    (call before process exit and before reading the checkpoint back).

    A writer-thread failure (disk full, unwritable root) is captured and
    re-raised, wrapped in :class:`CheckpointWriteError`, from ``wait()`` or
    the next ``save()``, whichever comes first.  ``last_committed`` only
    advances past a completed atomic commit and is read and written under a
    lock.
    """

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._last_committed: Optional[int] = None
        self._placed = False     # the last save's tree was on a mesh

    @property
    def last_committed(self) -> Optional[int]:
        with self._lock:
            return self._last_committed

    def save(self, step: int, tree: Params,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()                 # also re-raises a prior writer failure
        paths, leaves, unflatten = _flatten_with_paths(tree)
        # a placed leaf is gathered here, on every rank's calling thread
        host_tree = unflatten([_host_leaf(v) for v in leaves])
        self._placed = any(_pl.is_dtensor(v) for v in leaves)
        if self._placed:
            import torch.distributed as dist
            if dist.get_rank() != 0:
                return              # rank 0 alone writes; wait() meets it

        def work():
            try:
                save(self.root, step, host_tree, extra)
                with self._lock:
                    self._last_committed = step
                self._gc()
            except BaseException as exc:    # noqa: BLE001 — published, not
                with self._lock:            # swallowed: re-raised from the
                    self._error = exc       # calling thread in wait()
                return

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._placed:
            import torch.distributed as dist
            self._placed = False
            dist.barrier()
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise CheckpointWriteError(
                f"background checkpoint write failed: {err}") from err

    def _gc(self) -> None:
        if not os.path.isdir(self.root):
            return
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.root)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)
