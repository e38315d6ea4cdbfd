"""Shared model building blocks, the parts of ``repro.models.common`` that the
ported families use: the sharding environment, norms, RoPE, attention
through the fused kernel, MLPs, the losses and init helpers.

Everything is functional over parameter trees of plain dicts.  Products take
the activation dtype with fp32 accumulation inside the GEMM and round once to
the activation dtype, as the reference's ``preferred_element_type=float32``
followed by ``astype``; norm statistics, softmax and the logits are fp32.
One difference in bf16 only: where the reference applies an activation to
the fp32 product (the MLP's gate), the port applies it to the bf16-rounded
product.  In float32 the two are the same function.

Over a mesh (``ShardEnv.mesh`` set) the parameters and the batch are
DTensors, the model's torch ops run on them through DTensor's sharding
propagation (the reference's GSPMD), and the reference's
``with_sharding_constraint`` is :meth:`ShardEnv.constrain`, a
``redistribute`` to the sanitized placements.  The hand-written kernels
never see a DTensor: ``attention`` and ``kernel_call`` hand them each
rank's local shards through ``local_map``, in a layout where every rank
holds whole sequences and whole head dims.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.core import placement as _pl
from repro_torch.distributed.sharding import Spec
from repro_torch.kernels.flash_attention.ops import flash_attention

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Sharding environment: names the mesh axes so model code can place
# activation constraints without knowing the physical mesh.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardEnv:
    mesh: Any = None                     # a DeviceMesh with named dims
    dp: Tuple[str, ...] = ("data",)      # batch-parallel axes (pod+data)
    tp: Optional[str] = "model"          # tensor-parallel axis
    vocab_parallel: bool = True          # vocab-sharded chunked loss
    bf16_tp_reduce: bool = False         # bf16 partials for TP all-reduces
    gather_weights: bool = False         # explicit FSDP weight all-gather
    mode: str = "tp_sp"                  # "tp_sp" | "fsdp"

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Axes the batch dim shards over: in ``"fsdp"`` mode the whole
        mesh (no TP/SP; weights gathered per layer)."""
        if self.mode == "fsdp" and self.tp is not None:
            return tuple(self.dp) + (self.tp,)
        return tuple(self.dp)

    def out_proj_dtype(self) -> torch.dtype:
        """The dtype an output projection's (wo / w_down / out_proj) TP
        partial sums are reduced in: bf16 halves the bytes."""
        return torch.bfloat16 if self.bf16_tp_reduce else torch.float32

    def out_proj(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``h @ w`` for an output projection, in ``h``'s dtype.  In the
        ``"tp_sp"`` mode over a ``tp`` axis of more than one rank, the
        contraction is split over that axis and the partial sums are formed
        and summed in :meth:`out_proj_dtype` (:func:`split_product`, then
        the reduce-scatter to :meth:`act_btd`'s layout before the cast);
        elsewhere it is the plain product (fp32 accumulation inside the
        GEMM, one rounding)."""
        dt = self.out_proj_dtype()
        if (self.mesh is None or h.dtype == dt or self.mode == "fsdp"
                or self._axis_size(self.tp) == 1):
            return self.linear(h, w)
        return self.act_btd(split_product(self.gather_seq(h), w, self.tp, dt)).to(h.dtype)

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for an activation x (B, T, K).  Over a mesh x is
        gathered over the sequence first (:meth:`gather_seq`) and the
        product is :func:`anchor`-ed, so that its gradient comes back with
        the sequence whole too: DTensor flattens (B, T) into a GEMM's rows
        only with T whole, in the forward and in the backward alike."""
        if self.mesh is None:
            return x @ w
        return anchor(self.gather_seq(x) @ w)

    def weight(self, w: torch.Tensor, tp_dim: int) -> torch.Tensor:
        """A weight for use: in ``"fsdp"`` mode gathered whole; with
        ``gather_weights`` its FSDP shards gathered, keeping only dim
        ``tp_dim`` on the ``tp`` axis (-1: none); else as it is placed."""
        if self.mesh is None:
            return w
        if self.mode == "fsdp":
            return self.constrain(w, Spec(*([None] * w.ndim)))
        if not self.gather_weights:
            return w
        spec = [None] * w.ndim
        if tp_dim >= 0:
            spec[tp_dim] = self.tp
        return self.constrain(w, Spec(*spec))

    def _axis_size(self, names) -> int:
        if names is None:
            return 1
        size = 1
        for n in ((names,) if isinstance(names, str) else names):
            size *= _pl.axis_size(self.mesh, n)
        return size

    def sanitize(self, spec: Sequence, shape) -> Spec:
        """Drop spec entries whose mesh extent does not divide the dim (the
        non-divisible cases replicate rather than shard unevenly), and those
        of a dim of size 1 (placed on a one-rank axis, it shards nothing, and
        DTensor's view rules refuse to drop or flatten it)."""
        return Spec(*(None if names is not None
                      and (shape[i] == 1 or shape[i] % self._axis_size(names) != 0)
                      else names for i, names in enumerate(spec)))

    def constrain(self, x: torch.Tensor, spec: Sequence) -> torch.Tensor:
        """``x`` redistributed to ``spec`` (sanitized for its shape): the
        reference's ``with_sharding_constraint``."""
        if self.mesh is None:
            return x
        if not _pl.is_dtensor(x):
            raise TypeError(f"a ShardEnv with a mesh places DTensors, got a "
                            f"{type(x).__name__} of shape {tuple(x.shape)}")
        places = _pl.spec_placements(self.mesh, self.sanitize(spec, x.shape))
        if tuple(x.placements) == places:
            return x
        return x.redistribute(self.mesh, places)

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` whole on every rank (a loss before its backward)."""
        return self.constrain(x, Spec(*([None] * x.ndim)))

    # common activation layouts
    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) with the sequence whole on every rank: the all-gather
        Megatron-SP puts before a tensor-parallel region (GSPMD inserts it
        for the reference).  A product then flattens (B, T) with at most B
        sharded, which DTensor's view rules take."""
        return x if self.mesh is None else whole_dim(x, 1)

    def act_btd(self, x):    # (batch, seq, d_model): sequence-parallel
        if self.mode == "fsdp":
            return self.constrain(x, Spec(self.batch_axes, None, None))
        return self.constrain(x, Spec(self.dp, self.tp, None))

    def _bhtd(self, x) -> Spec:
        """act_bhtd's spec: TP over heads, over the sequence when the head
        count does not divide the model axis."""
        if self.mode == "fsdp":
            return Spec(self.batch_axes, None, None, None)
        if self.mesh is not None and x.shape[1] % self._axis_size(self.tp):
            return Spec(self.dp, None, self.tp, None)
        return Spec(self.dp, self.tp, None, None)

    def act_bhtd(self, x):   # (batch, heads, seq, head_dim)
        return self.constrain(x, self._bhtd(x))

    def act_btf(self, x):    # (batch, seq, d_ff) -> TP over hidden
        if self.mode == "fsdp":
            return self.constrain(x, Spec(self.batch_axes, None, None))
        return self.constrain(x, Spec(self.dp, None, self.tp))

    def act_btv(self, x):    # (batch, seq, vocab) -> TP over vocab
        if self.mode == "fsdp":
            return self.constrain(x, Spec(self.batch_axes, None, None))
        return self.constrain(x, Spec(self.dp, None, self.tp))

    def kernel_bhtd(self, q, k, v):
        """q (B, Hq, T, D) and k, v (B, Hkv, T', D) placed for the attention
        kernel: act_bhtd's layout with the sequence and head dims whole (a
        causal kernel over a sequence shard would be wrong).  Where q's
        heads shard and k/v's do not, k and v are repeated to q's head
        count first, so that each rank holds the KV heads of its q heads."""
        if self.mesh is None:
            return q, k, v
        hq, hkv = q.shape[1], k.shape[1]
        if (self.mode != "fsdp" and hq != hkv and hq % self._axis_size(self.tp) == 0
                and hkv % self._axis_size(self.tp)):
            k = k.repeat_interleave(hq // hkv, dim=1)
            v = v.repeat_interleave(hq // hkv, dim=1)

        def whole(x):
            spec = list(self._bhtd(x))
            spec[2] = spec[3] = None
            return self.constrain(x, Spec(*spec))
        return whole(q), whole(k), whole(v)

    def split_heads(self, x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
        """(B, T, n·hd) -> its (B, n, T, hd) view.  Over a mesh whose
        ``tp`` axis does not divide ``n``, the last dim is made whole
        first: a dim sharded over ``tp`` cannot be cut into ``n`` heads."""
        b, t, _ = x.shape
        if self.mesh is not None and n % self._axis_size(self.tp):
            x = whole_dim(x, 2)
        return x.reshape(b, t, n, hd).transpose(1, 2)

    def merge_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n, T, hd) -> (B, T, n·hd).  Over a mesh whose ``tp`` axis
        does not divide ``n``, the result is :func:`anchor`-ed: its
        gradient then comes back with the last dim whole, so that the
        backward can cut it into ``n`` heads."""
        b, n, t, hd = x.shape
        y = x.transpose(1, 2).reshape(b, t, n * hd)
        return anchor(y) if self.mesh is not None and n % self._axis_size(self.tp) else y


NO_SHARD = ShardEnv(mesh=None)


class _Anchor(torch.autograd.Function):
    """The identity on a DTensor, whose backward redistributes the gradient
    to the placements the tensor had (a partial sum's as replicated)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        ctx.mesh = x.device_mesh
        ctx.places = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) == ctx.places:
            return grad
        return grad.redistribute(ctx.mesh, ctx.places)


def anchor(x: torch.Tensor) -> torch.Tensor:
    """``x``, with its gradient laid out as ``x`` is (a plain tensor as it
    is).  A view's backward inverts the view on the gradient, in whatever
    layout the later ops left it: DTensor's view rules refuse a flatten
    whose inner dims are sharded, so a view that splits a dim (B·H into
    B, H; B·T into B, T) is anchored where its gradient may come back
    sharded inside the split."""
    return _Anchor.apply(x) if _pl.is_dtensor(x) else x


def embed(table: torch.Tensor, tokens: torch.Tensor, env: ShardEnv) -> torch.Tensor:
    """The rows of ``table`` (V, D) at ``tokens``.  Over a mesh the table is
    gathered whole for the lookup (its gradient, partial over the batch
    shards, is reduce-scattered back to the table's placement): DTensor's
    rules for a lookup in a vocab-sharded table, and for an index's
    backward over a sharded batch, do not hold on every torch release."""
    if env.mesh is None:
        return table[tokens]
    return F.embedding(tokens, env.replicate(table))


def write(dst: torch.Tensor, index: tuple, src: torch.Tensor) -> None:
    """``dst[index] = src`` in place (a decode cache's update); ``index``
    holds ints and whole slices (``:``).  Over a mesh ``src`` is laid out
    as that part of ``dst`` (replicated over a mesh dim that shards a dim
    ``index`` picks one entry of) and the rank that holds each entry
    writes it."""
    if not _pl.is_dtensor(dst):
        dst[index] = src
        return
    from torch.distributed.tensor import Replicate, Shard
    picked = [d for d, ix in enumerate(index) if isinstance(ix, int)]
    if any(not isinstance(ix, int) and ix != slice(None) for ix in index):
        raise ValueError(f"write takes ints and whole slices, got {index}")
    places = tuple(
        p if not p.is_shard() else Replicate() if p.dim in picked
        else Shard(p.dim - sum(d < p.dim for d in picked)) for p in dst.placements)
    if tuple(src.placements) != places:
        src = src.redistribute(dst.device_mesh, places)
    held = _pl.shard_slices(dst.device_mesh, dst.placements, dst.shape)
    if any(not held[d].start <= index[d] < held[d].stop for d in picked):
        return                      # another rank holds the entry
    dst.to_local()[tuple(ix - held[d].start if d in picked else ix
                         for d, ix in enumerate(index))] = src.to_local()


def whole_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with dim ``dim`` gathered on every rank (its other
    placements, partial sums included, kept, but a dim of size 1 replicated
    too, at no cost: it lies on a one-rank mesh axis, and DTensor's view
    rules refuse to flatten it placed there)."""
    from torch.distributed.tensor import Replicate
    places = tuple(Replicate() if p.is_shard() and (p.dim == dim or x.shape[p.dim] == 1)
                   else p for p in x.placements)
    return x if places == tuple(x.placements) else x.redistribute(x.device_mesh, places)


def kernel_call(fn: Callable, out_like: Sequence[int], *args):
    """``fn`` on each rank's local shards of the DTensors ``args`` (plain
    tensors and non-tensors pass as they are; with no DTensor among the
    arguments, ``fn(*args)``), through ``local_map``: the
    result ``i`` is placed as argument ``out_like[i]`` is (one index for a
    single result).  The gradients come back with the arguments'
    placements: ``fn`` must compute a whole shard of each result from the
    shards it gets (no dim it reduces over may be sharded)."""
    from torch.distributed.tensor.experimental import local_map
    dts = [a for a in args if _pl.is_dtensor(a)]
    if not dts:
        return fn(*args)
    places = [tuple(a.placements) if _pl.is_dtensor(a) else None for a in args]
    outs = tuple(places[i] for i in
                 ((out_like,) if isinstance(out_like, int) else out_like))
    return local_map(fn, out_placements=outs, in_placements=tuple(places),
                     device_mesh=dts[0].device_mesh)(*args)


class _WideProduct(torch.autograd.Function):
    """``h @ w`` (…, K) x (K, N) of operands in one dtype, its result in
    the wider ``dtype`` unrounded: on the card one GEMM with that output
    (``torch.mm(..., out_dtype=)``), on the CPU the product of widened
    copies (the same numbers: a product of two bf16 values is exact in
    fp32).  The backward takes its gradient in the operands' dtype: it is
    the gradient of the cast back to that dtype, which holds such values."""

    @staticmethod
    def forward(ctx, h, w, dtype):
        ctx.save_for_backward(h, w)
        h2 = h.reshape(-1, h.shape[-1])
        out = (torch.mm(h2, w, out_dtype=dtype) if h.is_cuda
               else h2.to(dtype) @ w.to(dtype))
        return out.reshape(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        return (g @ w.T, h.reshape(-1, h.shape[-1]).T @ g.reshape(-1, g.shape[-1]),
                None)


def split_product(h: torch.Tensor, w: torch.Tensor, tp: str,
                  dtype: torch.dtype) -> torch.Tensor:
    """``h @ w`` of DTensors h (B, T, K) and w (K, N), the contraction split
    over mesh dim ``tp``: on each rank the product of its K-slices with a
    ``dtype`` result, a partial sum over ``tp`` (summed in ``dtype`` when
    it is redistributed).  Over h's other mesh dims w is gathered whole and
    the result placed as h is (its gradient for w a partial sum there).
    Where ``tp`` does not divide K, every rank forms the whole product."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = h.device_mesh
    split = h.shape[-1] % _pl.axis_size(mesh, tp) == 0
    hin, win, out, wgrad = [], [], [], []
    for name, p in zip(mesh.mesh_dim_names, h.placements):
        if name == tp:
            places = ((Shard(2), Shard(0), Partial(), Shard(0)) if split else
                      (Replicate(),) * 4)
        elif p.is_replicate():
            places = (p, Replicate(), p, Replicate())
        elif p.is_shard() and p.dim < 2:
            places = (p, Replicate(), p, Partial())
        else:
            raise ValueError(f"split_product: h placed {tuple(h.placements)} on "
                             f"mesh dims {mesh.mesh_dim_names}")
        for ps, q in zip((hin, win, out, wgrad), places):
            ps.append(q)
    return local_map(lambda a, b: _WideProduct.apply(a, b, dtype), out_placements=(out,),
                     in_placements=(tuple(hin), tuple(win)),
                     in_grad_placements=(tuple(hin), tuple(wgrad)),
                     device_mesh=mesh, redistribute_inputs=True)(h, w)


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    w = 1.0 + scale.float() if plus_one else scale.float()
    return (y * w).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, H, T, D); positions: (B, T) or (T,), a plain tensor.  A
    DTensor ``x`` is rotated shard by shard; its T and D must be whole
    (``ShardEnv.kernel_bhtd``'s layout) and (B, T) positions replicated."""
    if _pl.is_dtensor(x):
        return kernel_call(functools.partial(apply_rope, theta=theta), 0,
                           x, positions)
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (D/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].float() * freqs        # (B,1,T,D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: one fused-kernel call each
# ---------------------------------------------------------------------------


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              q_offset: int = 0, env: ShardEnv = NO_SHARD) -> torch.Tensor:
    """q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D): the function of the reference's
    ``attention_xla`` (scale 1/sqrt(D)), which needs no q-chunk scan or band
    gather here: the kernel keeps its score tiles on chip and skips the key
    tiles the masks hide.  ``causal=False`` with Tq != Tk (an encoder's
    self-attention, a decoder's cross-attention) goes to the kernel as it
    is: every query sees every key.  Over a mesh, q/k/v are placed by
    ``env.kernel_bhtd`` and the kernel runs on each rank's shards."""
    fn = functools.partial(flash_attention, causal=causal, window=window,
                           softcap=softcap, q_offset=q_offset)
    return kernel_call(fn, 0, *env.kernel_bhtd(q, k, v))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     softcap: float = 0.0, rolling: bool = False,
                     env: ShardEnv = NO_SHARD) -> torch.Tensor:
    """One query token (B, Hq, 1, D) against a (possibly rolling) cache
    (B, Hkv, Tmax, D) holding ``length`` tokens; a rolling cache is a
    circular buffer whose valid slots are min(length, Tmax)."""
    tmax = k_cache.shape[2]
    fn = functools.partial(flash_attention, causal=False, softcap=softcap,
                           kv_len=min(length, tmax) if rolling else length)
    return kernel_call(fn, 0, *env.kernel_bhtd(q, k_cache, v_cache))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(params: Params, x: torch.Tensor, mlp_type: str,
              env: ShardEnv = NO_SHARD) -> torch.Tensor:
    up = env.linear(x, env.weight(params["w_up"], 1))
    if mlp_type in ("swiglu", "geglu"):
        act = F.silu if mlp_type == "swiglu" else gelu
        h = act(env.linear(x, env.weight(params["w_gate"], 1)).float()) * up.float()
    elif mlp_type == "relu2":  # nemotron squared-ReLU
        h = torch.relu(up.float()) ** 2
    elif mlp_type == "gelu":
        h = gelu(up.float())
    else:
        raise ValueError(mlp_type)
    return env.out_proj(env.act_btf(h.to(x.dtype)), env.weight(params["w_down"], 0))


def mlp_init(gen: torch.Generator, d: int, f: int, mlp_type: str, dtype,
             device) -> Params:
    p = {}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (d, f), dtype, device)
    p["w_up"] = dense_init(gen, (d, f), dtype, device)
    p["w_down"] = dense_init(gen, (f, d), dtype, device)
    return p


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _largest_divisor_leq(n: int, target: int) -> int:
    target = max(1, min(n, target))
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return 1


def _chunk_nll(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               softcap: float, z_loss: float, env: ShardEnv,
               vocab_parallel: bool) -> torch.Tensor:
    """Summed next-token NLL (+ z-loss) of one token chunk: h (B, sc, D).
    Over a mesh the logits are placed by ``env.act_btv`` and, with
    ``vocab_parallel``, the gold logit is a one-hot sum (Megatron-style:
    no gather across vocab shards)."""
    logits = env.linear(h.float(), head.float())        # (B, sc, V) fp32
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = env.act_btv(logits)
    lse = torch.logsumexp(logits, dim=-1)
    if env.mesh is not None and vocab_parallel:
        onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
        gold = (logits * onehot).sum(dim=-1)
    else:
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss > 0.0:
        nll = nll + z_loss * lse ** 2
    return nll.sum()


def chunked_lm_loss(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, *, softcap: float = 0.0,
                    z_loss: float = 1e-4, token_chunk: int = 8192,
                    env: ShardEnv = NO_SHARD, vocab_parallel: bool = True
                    ) -> torch.Tensor:
    """Token-mean cross-entropy (+ z-loss) from the final hidden states
    (B, T, D) without the whole (B, T, V) logits: the sequence is cut into
    chunks of ``sc`` tokens (the largest divisor of T up to
    ``token_chunk / B``), each chunk's fp32 logits formed inside a body
    checkpointed under grad mode, so the backward recomputes them too (the
    reference's ``jax.checkpoint`` over a ``lax.scan``).

    Over a mesh, as the reference: ``vocab_parallel`` places the head once
    as (d whole x vocab on ``tp``) so each chunk's logits come out
    vocab-sharded, and in ``"fsdp"`` mode the chunks are at least 65,536
    tokens (the head's gradient is reduced once per chunk).  The loss is
    then replicated, ready for its backward."""
    b, t, _ = hidden.shape
    hidden = env.gather_seq(hidden)
    if env.mesh is not None and env.mode == "fsdp":
        token_chunk = max(token_chunk, 65536)
    sc = _largest_divisor_leq(t, max(1, token_chunk // max(b, 1)))
    if vocab_parallel and env.mesh is not None:
        head = env.constrain(head, Spec(None, env.tp if env.mode == "tp_sp"
                                        else None))
    remat = torch.is_grad_enabled()
    total = 0.0
    for lo in range(0, t, sc):
        args = (hidden[:, lo:lo + sc], head, labels[:, lo:lo + sc], softcap,
                z_loss, env, vocab_parallel)
        total = total + (checkpoint(_chunk_nll, *args, use_reentrant=False)
                         if remat else _chunk_nll(*args))
    loss = total / (b * t)
    return env.replicate(loss) if env.mesh is not None else loss


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 1e-4,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross-entropy (+ z-loss) in fp32. logits (..., V)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    nll = lse - lf.gather(-1, labels[..., None].long())[..., 0]
    if z_loss > 0.0:
        nll = nll + z_loss * lse ** 2
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# Init helpers: the reference's shapes, scales and distributions (not its
# bits: torch cannot replay jax.random)
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape: Sequence[int], dtype, device,
           std: float = 1.0) -> torch.Tensor:
    t = torch.randn(tuple(shape), generator=gen, device=device)
    return (t * std).to(dtype)


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype, device,
               fan_in: Optional[int] = None) -> torch.Tensor:
    return normal(gen, shape, dtype, device, 1.0 / math.sqrt(fan_in or shape[0]))


def stack_layer_params(n: int, init_fn: Callable[[int], Params]) -> Params:
    """Initialize ``n`` layers and stack each leaf along a new leading axis
    (the reference's scan-over-layers layout).  The layers are drawn in
    order and each copied into a preallocated stack before the next is
    drawn, so the peak is the stack and one layer (not the layers twice)."""
    stack = None
    for i in range(n):
        layer = init_fn(i)
        if stack is None:
            stack = pytree.tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), layer)
        for dst, src in zip(pytree.tree_leaves(stack), pytree.tree_leaves(layer)):
            dst[i].copy_(src)
        del layer
    return stack


def unstack(tree: Params, n: int):
    """The ``n`` per-layer trees of a stacked parameter tree (views, no
    copy), each leaf unbound once along its layer axis."""
    parts = {key: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for key, v in tree.items()}
    return [{key: part[i] for key, part in parts.items()} for i in range(n)]


def layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    return {key: layer(v, i) if isinstance(v, dict) else v[i]
            for key, v in tree.items()}
