"""Per-rank cost and memory of one traced step: the port's counterpart of
``benchmarks/hlo_analysis.py::analyze_hlo`` and of ``memory_analysis()``.

The reference lowers a step with GSPMD and reads the per-device program's
optimized HLO.  The port has no compiled program: it runs the step once,
eagerly, under :class:`CostRecorder`, a ``TorchDispatchMode``, with every
tensor on ``meta`` (no data, no memory) and every DTensor on a mesh of
torch's ``fake`` process group.  The recorder returns ``NotImplemented`` for
an op on DTensors, so that DTensor's dispatch runs first and the recorder
sees the ops it issues on rank 0's LOCAL shards and the collectives of its
redistributions: every figure is per rank, as the reference's SPMD module
is the per-device program (a mode that counted the DTensor-level ops would
count the global work, the whole mesh's).  DTensor's sharding propagation
runs ops on fake tensors to learn output shapes; those are not the step's
work and are skipped.  The keys of :meth:`CostRecorder.hlo` are
``analyze_hlo``'s:

* ``flops``: 2·M·N·K per matrix product of local operands (torch's
  ``flop_counter`` formulas: ``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions, SDPA), as ``analyze_hlo`` counts ``dot``s only; a kernel
  wrapper's call (``kernels._record.kernel``) counts the formula of the
  kernel's own bound, on its local operands (attention: 4·B·Hq·D per
  visible (query, key) pair; ``ssd_chunk``: the chunk's C·Bᵀ and W·X over
  the causal half and its state product), and the ops inside it are not
  counted (they are the kernel's).
* ``hbm_bytes``: Σ (operand + result bytes) over the ops that move data.
  In eager mode each op is one launch that reads its operands from memory
  and writes its result, as a fusion is in the reference's optimized HLO;
  views and allocations move nothing.  A kernel's call counts its inputs
  read once and its outputs written once.
* ``hbm_bytes_fused``: the same without pointwise ops, casts and copies:
  the closest eager reading of the reference's "fused bytes", which skips
  the elementwise ops a TPU compile fuses into their neighbours.  It is
  the traffic a fusing compiler would leave, not what eager mode moves.
* ``collective_bytes`` and ``<kind>_bytes`` / ``<kind>_count`` for
  all-gather, all-reduce, reduce-scatter, all-to-all and
  collective-permute (sends, receives and broadcasts): Σ result bytes of
  each collective on rank 0, as ``analyze_hlo`` sums the per-device result
  shapes.  The mesh must be a ``"cuda"`` mesh: on a ``"cpu"`` one DTensor
  replaces an all-to-all by an all-gather and a chunk, which NCCL never
  does.
* ``collective_bytes_by_axis``: the same bytes by the mesh axes each
  collective's process group spans (``"model"``, ``"data"``, ``"pod"``,
  or several joined by ``+``), which ``analyze_hlo`` cannot tell apart:
  on H100 nodes the ``model`` axis runs over NVLink, the others over the
  network (``launch.mesh``).
* ``top_collective_sites``: bytes by site and axes, the site the innermost
  ``repro_torch`` functions on the Python stack when the collective was
  issued (the reference keeps the tail of the op's name path), largest
  first.

Memory (:attr:`CostRecorder.live`, :attr:`CostRecorder.peak`) is the live
bytes of rank 0's local tensors: each storage an op creates is counted from
its creation until it is freed, the step's arguments (:meth:`track`) from
the start; the peak is the most at once, the counterpart of the compiled program's ``peak_memory_in_bytes``
and of the card's ``torch.cuda.max_memory_allocated`` over the same step.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import weakref
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _record

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KINDS = (("reduce_scatter", "reduce-scatter"), ("all_gather", "all-gather"),
          ("allgather", "all-gather"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("send", "collective-permute"),
          ("recv", "collective-permute"), ("broadcast", "collective-permute"))
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "detach", "alias",
               "_unsafe_view", "wait_tensor", "_wrap_tensor_autograd",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset"}
_MOVES = {"_to_copy", "copy", "copy_", "clone", "cat", "stack",
          "constant_pad_nd", "fill", "fill_", "zero_", "zeros_like",
          "ones_like", "full_like", "expand_copy"}
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)


def _tensors(tree):
    """The tensors of a tree of containers and dataclasses (a ``Batch``)."""
    out = []
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            out.extend(_tensors([getattr(leaf, f.name) for f in dataclasses.fields(leaf)]))
    return out


def _flat(values) -> list:
    """The tensors among an op's arguments or results (tensors and lists
    of tensors; no deeper nesting reaches an aten op)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def attention_pairs(tq: int, tk: int, *, causal: bool, window: int,
                    q_offset: int = 0, kv_len: Optional[int] = None) -> int:
    """Visible (query, key) pairs of one head's attention: query ``i`` at
    position ``i + q_offset`` sees the keys ``j < kv_len`` that the causal
    mask and the sliding window leave (the mask of ``ref.attention_ref``)."""
    kv = tk if kv_len is None else max(0, min(int(kv_len), tk))
    pos = np.arange(q_offset, q_offset + tq, dtype=np.int64)   # no torch op
    hi = np.minimum(pos, kv - 1) if causal else np.full_like(pos, kv - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros_like(pos)
    return int(np.maximum(hi - lo + 1, 0).sum())


def kernel_work(name: str, args, out) -> tuple:
    """(flops, bytes) of one kernel call on its local operands, by the
    formulas of the kernel's bound: inputs read once, outputs written
    once."""
    ins = _tensors(args)
    nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, _tensors(out)))
    if name == "flash_attention":
        q, k, v, _, kw = args[:5]
        b, hq, tq, d = q.shape
        kv = k.shape[2] if kw.get("kv_len") is None else min(kw["kv_len"], k.shape[2])
        pairs = attention_pairs(tq, k.shape[2], causal=kw["causal"],
                                window=kw["window"], q_offset=kw["q_offset"],
                                kv_len=kw.get("kv_len"))
        # q read and o written; of k and v the valid slots alone are read
        nbytes = 2 * _nbytes(q) + 2 * b * k.shape[1] * kv * d * k.element_size()
        return 4.0 * b * hq * pairs * d, float(nbytes)
    if name == "ssd_chunk":
        x, b_ = args[0], args[3]
        chunk = args[6]
        bh, t, p = x.shape
        s = b_.shape[-1]
        nc, L = t // chunk, chunk
        flops = bh * nc * (L * (L + 1) / 2 * (2.0 * s + 2.0 * p) + 2.0 * L * s * p)
        return flops, float(nbytes)
    return 0.0, float(nbytes)      # a kernel no model step calls


def _kind(func) -> Optional[str]:
    name = func._overloadpacket.__name__ if hasattr(func, "_overloadpacket") else str(func)
    ns = getattr(func, "namespace", "")
    if ns not in ("_c10d_functional", "c10d", "c10d_functional"):
        return None
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


def _site() -> str:
    """The three innermost ``repro_torch`` frames, outermost first, as
    ``module.function`` (this module's own frames skipped)."""
    names = []
    f = sys._getframe(2)
    while f is not None and len(names) < 3:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_PACKAGE) and fn != _SELF:
            mod = os.path.splitext(os.path.relpath(fn, _PACKAGE))[0]
            names.append(f"{mod.replace(os.sep, '.')}.{f.f_code.co_name}")
        f = f.f_back
    return "/".join(reversed(names)) or "(outside repro_torch)"


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors (a DTensor's
    local shard), each once: what they hold on a device."""
    from repro_torch.core import placement as _pl
    seen = {}
    for t in _tensors(tree):
        st = _pl.local(t).untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class CostRecorder(TorchDispatchMode):
    """Counts the flops, bytes, collectives and live memory of the local
    ops it sees (module docstring).  Enter it with :func:`recording`."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.flops = 0.0
        self.bytes = 0.0
        self.fused_bytes = 0.0
        self.coll = dict.fromkeys(COLLECTIVES, 0)
        self.coll_counts = dict.fromkeys(COLLECTIVES, 0)
        self.axes: Dict[str, int] = collections.Counter()
        self.sites: Dict[tuple, int] = collections.Counter()
        self._group_axes: Dict[str, str] = {}
        self.kernels: Dict[str, int] = collections.Counter()
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}     # id(storage) -> bytes
        self._hidden = 0

    # -- memory -------------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        shard) as live from now: the step's arguments.  Returns their
        bytes, each storage once."""
        from repro_torch.core import placement as _pl
        before = self.live
        for t in _tensors(tree):
            self._hold(_pl.local(t))
        return self.live - before

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor issue the local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        outs = _flat(out if isinstance(out, (list, tuple)) else (out,))
        ins = _flat(args) + _flat(kwargs.values())
        if any(isinstance(t, FakeTensor) for t in outs + ins):
            return out                   # DTensor's sharding propagation
        for t in outs:
            self._hold(t)
        if self._hidden:
            return out
        name = func._overloadpacket.__name__
        kind = _kind(func)
        if kind is not None:
            n = sum(map(_nbytes, outs))
            self.coll[kind] += n
            self.coll_counts[kind] += 1
            axes = self._axes(args)
            self.axes[axes] += n
            self.sites[(_site(), axes)] += n
        if name in _NO_TRAFFIC or getattr(func, "is_view", False):
            return out
        from torch.utils.flop_counter import flop_registry
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += float(count(*args, **kwargs, out_val=out))
        moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.bytes += moved
        if torch.Tag.pointwise not in func.tags and name not in _MOVES:
            self.fused_bytes += moved
        return out

    def _axes(self, args) -> str:
        """The mesh axes along which the ranks of a collective's group differ,
        joined by ``+``; the group's name when the recorder has no mesh.  A
        functional collective names its group by its last string argument,
        a ``c10d`` one passes the group itself, first of its script objects."""
        from torch.distributed import ProcessGroup
        names = [a for a in args if isinstance(a, str)]
        name = names[-1] if names else ProcessGroup.unbox(
            next(a for a in args if isinstance(a, torch.ScriptObject))).group_name
        if name not in self._group_axes:
            axes = name
            if self.mesh is not None:
                import torch.distributed as dist
                from torch.distributed.distributed_c10d import _resolve_process_group
                ranks = dist.get_process_group_ranks(_resolve_process_group(name))
                at = np.argwhere(np.isin(self.mesh.mesh.cpu().numpy(), ranks))
                axes = "+".join(n for d, n in enumerate(self.mesh.mesh_dim_names)
                                if len(set(at[:, d])) > 1)
            self._group_axes[name] = axes
        return self._group_axes[name]

    # -- the kernel hook (kernels._record) ------------------------------------
    def opaque(self, name: str, fn, args, kwargs):
        """A kernel wrapper's call: its formula, its inner ops hidden (their
        outputs still count as memory)."""
        self._hidden += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._hidden -= 1
        if not self._hidden:
            flops, nbytes = kernel_work(name, args, out)
            self.flops += flops
            self.bytes += nbytes
            self.fused_bytes += nbytes
            self.kernels[name] += 1
        return out

    def scoped(self, scope: str, fn, args, kwargs):
        return fn(*args, **kwargs)

    def step(self, fn, args):
        return fn(*args)

    # -- results --------------------------------------------------------------
    def hlo(self, top_sites: int = 12) -> Dict[str, object]:
        """``analyze_hlo``'s keys, per rank."""
        out = {"flops": self.flops, "hbm_bytes": self.bytes,
               "hbm_bytes_fused": self.fused_bytes,
               "collective_bytes": sum(self.coll.values())}
        for k in COLLECTIVES:
            out[f"{k}_bytes"] = self.coll[k]
            out[f"{k}_count"] = self.coll_counts[k]
        out["collective_bytes_by_axis"] = dict(self.axes)
        sites = sorted(self.sites.items(), key=lambda kv: -kv[1])[:top_sites]
        out["top_collective_sites"] = [{"site": s, "axes": a, "bytes": b}
                                       for (s, a), b in sites]
        return out


@contextlib.contextmanager
def recording(mesh=None) -> Iterator[CostRecorder]:
    """A :class:`CostRecorder` active for the block, the kernel wrappers'
    calls routed to it (``kernels._record.ACTIVE``); ``mesh`` names the
    axes of its collectives."""
    rec = CostRecorder(mesh)
    token = _record.ACTIVE.set(rec)
    try:
        with rec:
            yield rec
    finally:
        _record.ACTIVE.reset(token)


def analyze(fn, *args, mesh=None, **kwargs) -> Dict[str, object]:
    """``analyze_hlo``'s keys for one run of ``fn(*args, **kwargs)``, the
    collectives' axes named by ``mesh``."""
    with recording(mesh) as rec:
        fn(*args, **kwargs)
    return rec.hlo()
