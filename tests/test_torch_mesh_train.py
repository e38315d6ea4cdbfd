"""Training over a device mesh: the port's 2 x 2 train step against the
reference's, on the CPU.

One reference process (four forced jax CPU devices, as
``tests/test_distributed.py`` runs its sharded step) and four gloo ranks of
the port (processes that meet at a ``FileStore`` under the test's temporary
directory) run at once.  Both build the same parameters from NumPy (the
port's CPU init, every all-zero norm and bias redrawn from a seed; carried to
the port through ``convert.params_from_numpy``) and the same NumPy batch, and
take one AdamW step, meshed and on one device:

* yi-9b SMOKE on 2 x 2 in the ``tp_sp`` and the ``fsdp`` mode,
* zamba2 SMOKE on 2 x 2, both kernels' plain versions on local shards,
* nemotron SMOKE on 1 x 4, whose 6 heads the model axis does not divide
  (the sequence is gathered before attention),
* mixtral SMOKE on 2 x 2 with a capacity factor of 1.0, so that the
  per-shard dispatch drops tokens.

The loss and ``grad_norm`` match the reference's meshed step at rtol 1e-4,
the parameters after the step at rtol 1e-3 / atol 1e-3 x max, and the loss
lies within 1e-2 of the one-device step (``tests/test_distributed.py``'s
bound).  The ranks also run ``compressed_psum`` (the reference's bounds),
``AsyncCheckpointer`` (one writer, the files of a plain save) and
``checkpoint.restore(..., shardings)`` from 4 ranks onto a 2-rank mesh,
hold ``forward`` and ``decode_step`` over a 2 x 2 and a 4 x 1 mesh to the port's own
results without one, and hold a bf16 output projection over the model axis
to one device's fp32 product.  A last test runs ``launch.train --mesh data=2,model=2 --device cpu`` under
``torchrun`` through a crash and a resume.
"""

import inspect
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
WORLD = 4
# the first step's rate is 1e-3, tests/test_distributed.py's peak rate: a
# first AdamW step moves each weight by about lr·sign(g), so a gradient within
# rounding of zero moves its weight by up to 2·lr either way
LR = dict(peak_lr=1e-2, warmup=10, total=20)
# name -> (arch, config overrides, mesh shape, mode)
CASES = {
    "yi_tp_sp": ("yi-9b", {}, (2, 2), "tp_sp"),
    "yi_fsdp": ("yi-9b", {}, (2, 2), "fsdp"),
    "zamba2": ("zamba2-2.7b", {}, (2, 2), "tp_sp"),
    "nemotron_14": ("nemotron-4-15b", {}, (1, 4), "tp_sp"),
    "mixtral_drops": ("mixtral-8x7b", {"capacity_factor": 1.0}, (2, 2), "tp_sp"),
}


# forward and decode over a 2 x 2 and a 4 x 1 mesh (the port against itself
# without one): GQA with one KV head, the hybrid's and Mamba's caches, the
# encoder-decoder's frames
INFER = ("yi-9b", "zamba2-2.7b", "mamba2-370m", "seamless-m4t-medium")


def numpy_inputs(arch, overrides):
    """(config, parameter tree of NumPy arrays, tokens, labels): the port's
    CPU init with every all-zero leaf redrawn (around 1 for the Mamba norms,
    which have no ``plus_one``), and an (8, 32) random-walk batch."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(7)
    paths, leaves, unflatten = _flatten_with_paths(params)
    out = []
    for p, t in zip(paths, leaves):
        a = t.numpy().copy()
        if not a.any():
            centre = 1.0 if (cfg.family in ("hybrid", "ssm") and p.endswith("norm")
                             and not p.startswith("shared")) else 0.0
            a = (centre + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        out.append(a)
    base = rng.integers(0, cfg.vocab_size, (8, 1))
    tokens = ((base + np.cumsum(rng.integers(-3, 4, (8, 32)), axis=1))
              % cfg.vocab_size).astype(np.int32)
    return cfg, unflatten(out), tokens, np.roll(tokens, -1, axis=1)


_REF = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core.compat import make_mesh
from repro.data.pipeline import Batch
from repro.distributed import sharding as shlib
from repro.models import common as cm
from repro.models.model import build_model
from repro.optim import make_optimizer
from repro.train.step import TrainState, make_train_step
CASES, LR, prefix = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[-1]
{numpy_inputs}

meta, arrays = {{}}, {{}}
for name, (arch, over, shape, mode) in CASES.items():
    cfg, tree, tokens, labels = numpy_inputs(arch, over)
    model = build_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = make_optimizer("adamw", **LR)
    state = TrainState(params=params, opt_state=opt.init(params))
    batch = Batch(tokens=jnp.asarray(tokens), labels=jnp.asarray(labels))
    _, single = jax.jit(make_train_step(model, opt))(state, batch)
    mesh = make_mesh(tuple(shape), ("data", "model"))
    env = cm.ShardEnv(mesh=mesh, dp=("data",), tp="model", mode=mode)
    ss = TrainState(params=shlib.param_shardings(params, mesh),
                    opt_state=shlib.opt_state_shardings(state.opt_state, params, mesh))
    step = jax.jit(make_train_step(model, opt, env),
                   in_shardings=(ss, shlib.to_shardings(
                       shlib.batch_specs(batch, mesh, ("data",)), mesh)),
                   out_shardings=(ss, None))
    with mesh:
        new, m = step(state, batch)
    paths, leaves, _ = shlib.tree_paths(new.params)
    for p, l in zip(paths, leaves):
        arrays[f"{{name}}|{{p}}"] = np.asarray(l)
    meta[name] = {{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                  "single_loss": float(single["loss"])}}
np.savez(prefix + ".npz", **arrays)
with open(prefix + ".json", "w") as f:
    json.dump(meta, f)
"""

_RANK = """
import json, os, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
CASES, LR, INFER = (json.loads(a) for a in sys.argv[4:7])
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                        rank=rank, world_size=world)
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.convert import params_from_numpy
from repro_torch.core import placement as pl
from repro_torch.core.compat import make_mesh
from repro_torch.data.pipeline import Batch
from repro_torch.distributed import compressed_psum, sharding as shlib
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssd import ops as sops
from repro_torch.models import common as cm, moe
from repro_torch.models.model import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train.step import TrainState, make_train_step
{numpy_inputs}

seen = {{"attention": [], "ssd": [], "dropped": []}}
attention_ref, ssd_chunk_ref, scatter = fops.attention_ref, sops.ssd_chunk_ref, moe._scatter

def attention_seen(q, k, v, **kw):
    assert not pl.is_dtensor(q)
    seen["attention"].append([list(q.shape), list(k.shape)])
    return attention_ref(q, k, v, **kw)

def ssd_seen(x, *args, **kw):
    assert not pl.is_dtensor(x)
    seen["ssd"].append(list(x.shape))
    return ssd_chunk_ref(x, *args, **kw)

def scatter_seen(x_rep, assign, pos, keep, e, cap):
    seen["dropped"].append(int((~keep).sum()))
    return scatter(x_rep, assign, pos, keep, e, cap)

fops.attention_ref, sops.ssd_chunk_ref, moe._scatter = attention_seen, ssd_seen, scatter_seen

meta, arrays = {{}}, {{}}
for name, (arch, over, shape, mode) in CASES.items():
    for v in seen.values():
        v.clear()
    cfg, tree, tokens, labels = numpy_inputs(arch, over)
    model = build_model(cfg)
    opt = make_optimizer("adamw", **LR)
    params = params_from_numpy(tree, "cpu")
    batch = Batch(torch.from_numpy(tokens), torch.from_numpy(labels))
    single = make_train_step(model, opt)(TrainState(params, opt.init(params)), batch)[1]
    params = params_from_numpy(tree, "cpu")
    mesh = make_mesh(tuple(shape), ("data", "model"), device_type="cpu")
    env = cm.ShardEnv(mesh=mesh, dp=("data",), tp="model", mode=mode)
    state = TrainState(params, opt.init(params))
    placed = TrainState(
        shlib.distribute(params, shlib.param_shardings(params, mesh)),
        shlib.distribute(state.opt_state,
                         shlib.opt_state_shardings(state.opt_state, params, mesh)))
    specs = shlib.batch_specs(batch, mesh, ("data",))
    dbatch = Batch(*(pl.place(t, mesh, pl.spec_placements(mesh, s))
                     for t, s in ((batch.tokens, specs.tokens), (batch.labels, specs.labels))))
    seen["attention"].clear(); seen["ssd"].clear(); seen["dropped"].clear()
    new, m = make_train_step(model, opt, env)(placed, dbatch)
    paths, leaves, _ = shlib.tree_paths(new.params)
    for p, l in zip(paths, leaves):
        arrays[f"{{name}}|{{p}}"] = pl.gather(l).numpy()
    meta[name] = {{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                  "single_loss": float(single["loss"]), "seen": {{k: list(v) for k, v in seen.items()}},
                  "placed": all(pl.is_dtensor(l) for l in leaves),
                  "count": int(pl.local(new.opt_state["count"]))}}

# forward and decode over a 2 x 2 mesh, and over a 4 x 1 one (a one-rank
# model axis: the single token's sequence dim placed on it), against the port
# without one
mesh22 = make_mesh((2, 2), ("data", "model"), device_type="cpu")
mesh41 = make_mesh((4, 1), ("data", "model"), device_type="cpu")

def place(t, mesh=mesh22):
    return pl.place(t, mesh, pl.spec_placements(
        mesh, shlib.Spec("data", *([None] * (t.ndim - 1)))))

for key, mesh in (("infer", mesh22), ("infer41", mesh41)):
    for arch in INFER:
        cfg, tree, tokens, _ = numpy_inputs(arch, {{}})
        model = build_model(cfg)
        params = params_from_numpy(tree, "cpu")
        placed = shlib.distribute(params, shlib.param_shardings(params, mesh))
        env = cm.ShardEnv(mesh=mesh)
        tok = torch.from_numpy(tokens[:4, :6])
        frames = (torch.from_numpy(np.random.default_rng(3).normal(
            size=(4, 6, cfg.frontend_dim)).astype(np.float32)) if cfg.family == "encdec" else None)
        with torch.no_grad():
            want, _ = model.forward(params, tok, frames)
            got, _ = model.forward(placed, place(tok, mesh),
                                   None if frames is None else place(frames, mesh), env=env)
            errs = [float((pl.gather(got) - want).abs().max())]
            kw = {{"enc_len": 6}} if frames is not None else {{}}
            cache = model.init_cache(4, 8, device="cpu", **kw)
            dcache = shlib.distribute(cache, shlib.to_shardings(
                shlib.cache_specs(cache, mesh, ("data",)), mesh))
            if frames is not None:
                cache["enc_out"] = model.module.encode(params, cfg, frames)
                dcache["enc_out"] = model.module.encode(placed, cfg, place(frames, mesh), env)
            for i in range(tok.shape[1]):
                lw, cache = model.decode_step(params, cache, tok[:, i:i + 1])
                lg, dcache = model.decode_step(placed, dcache, place(tok[:, i:i + 1], mesh),
                                               env=env)
                errs.append(float((pl.gather(lg) - lw).abs().max()))
        meta[f"{{key}}_{{arch}}"] = {{"errs": errs, "scale": float(want.abs().max()),
                                     "placed": pl.is_dtensor(got) and pl.is_dtensor(lg)}}

# an output projection in bf16 over the model axis (w_down's placement): its
# partial sums formed and reduced in fp32, against one device's fp32 product
g = torch.Generator().manual_seed(5)
h = torch.randn(4, 8, 64, generator=g).bfloat16()
w = torch.randn(64, 32, generator=g).bfloat16()
r = torch.randn(4, 8, 32, generator=g)
hr, wr = h.clone().requires_grad_(), w.clone().requires_grad_()
want = (hr.float() @ wr.float()).bfloat16()
(want.float() * r).sum().backward()
env = cm.ShardEnv(mesh=mesh22)
hd = pl.place(h, mesh22, pl.spec_placements(mesh22, shlib.Spec("data", None, "model")))
wd = pl.place(w, mesh22, pl.spec_placements(mesh22, shlib.Spec("model", "data")))
hd.requires_grad_(); wd.requires_grad_()
got = env.out_proj(hd, wd)
(got.float() * place(r)).sum().backward()
meta["out_proj"] = {{"placements": [repr(p) for p in got.placements],
                    **{{k: [pl.gather(a.detach()).float().numpy().tolist(), b.detach().float().numpy().tolist()]
                       for k, a, b in (("y", got, want), ("dh", hd.grad, hr.grad),
                                       ("dw", wd.grad, wr.grad))}}}}

# compressed_psum over a 4-rank axis (tests/test_distributed.py's case)
mesh4 = make_mesh((4,), ("pod",), device_type="cpu")
x = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
errs = []
for trial in range(5):
    gen = torch.Generator().manual_seed(1000 * trial + rank)
    got = compressed_psum(torch.from_numpy(x[rank]), mesh4, "pod", gen)
    errs.append((got.numpy() - x.sum(0)).tolist())
meta["compressed_psum"] = {{"errs": errs, "scale": float(np.abs(x.sum(0)).max()),
                           "dtype": str(got.dtype), "shape": list(got.shape)}}

# AsyncCheckpointer on a placed tree: one writer, the files of a plain save
whole = torch.arange(64.0).reshape(8, 8)
placed = pl.place(whole, mesh22, pl.spec_placements(mesh22, shlib.Spec("data", "model")))
saver = ck.AsyncCheckpointer(os.path.join(tmp, "async"))
saver.save(3, {{"x": placed, "n": np.int32(7)}})
writer = saver._thread is not None
saver.wait()
meta["async"] = {{"writer": writer,
                 "committed": ck.latest_step(os.path.join(tmp, "async"))}}
if rank == 0:
    ck.save(os.path.join(tmp, "plain"), 3, {{"x": whole, "n": np.int32(7)}})

# restore(..., shardings): saved from four ranks, restored onto two
ck.save(os.path.join(tmp, "elastic"), 0, {{"x": placed}})
dist.barrier()
dist.destroy_process_group()
if rank < 2:
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store2"), 2),
                            rank=rank, world_size=2)
    mesh2 = make_mesh((2,), ("data",), device_type="cpu")
    out = ck.restore(os.path.join(tmp, "elastic"), 0, {{"x": torch.zeros(8, 8)}},
                     {{"x": shlib.Sharding(mesh2, shlib.Spec(None, "data"))}}, device="cpu")
    meta["elastic"] = {{"placements": [str(p) for p in out["x"].placements],
                       "local": list(out["x"].to_local().shape),
                       "equal": bool(torch.equal(out["x"].full_tensor(), whole))}}
    dist.destroy_process_group()
np.savez(os.path.join(tmp, f"rank{{rank}}.npz"), **arrays)
with open(os.path.join(tmp, f"rank{{rank}}.json"), "w") as f:
    json.dump(meta, f)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(ROOT), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


def _script(tmp, name, template):
    path = tmp / name
    path.write_text(template.format(
        numpy_inputs=textwrap.dedent(inspect.getsource(numpy_inputs))))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (one process, four jax devices) and the port (four
    gloo ranks), all at once; what each wrote."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    args = [json.dumps(CASES), json.dumps(LR), json.dumps(INFER)]
    procs = [("reference", subprocess.Popen(
        [sys.executable, _script(tmp, "ref.py", _REF), *args, str(tmp / "ref")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu")))]
    rank_py = _script(tmp, "rank.py", _RANK)
    for r in range(WORLD):
        procs.append((f"rank {r}", subprocess.Popen(
            [sys.executable, rank_py, str(r), str(WORLD), str(tmp), *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(OMP_NUM_THREADS="1"))))
    logs = {}
    try:
        for name, p in procs:
            logs[name] = p.communicate(timeout=400)[0]
    finally:
        for _, p in procs:
            p.kill()
    for name, p in procs:
        log = "\n".join(ln for ln in logs[name].splitlines() if "arn" not in ln)
        assert p.returncode == 0, f"{name} failed:\n{log[-4000:]}"

    def load(prefix):
        meta = json.loads((tmp / f"{prefix}.json").read_text())
        with np.load(tmp / f"{prefix}.npz") as z:
            return meta, {k: z[k] for k in z.files}
    return tmp, load("ref"), [load(f"rank{r}") for r in range(WORLD)]


@pytest.mark.parametrize("name", list(CASES))
def test_meshed_step_matches_reference(runs, name):
    """Loss and grad_norm at rtol 1e-4 against the reference's meshed step,
    the parameters after one AdamW step at rtol 1e-3 / atol 1e-3 x max, the
    loss within 1e-2 of the one-device step (for mixtral, whose drops differ
    there, the gap to it equals the reference's); every rank alike, every
    leaf of the new state placed."""
    _, (ref_meta, ref_vals), ports = runs
    want = ref_meta[name]
    for rank, (meta, vals) in enumerate(ports):
        got = meta[name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
        if name == "mixtral_drops":     # drops differ: see the MoE test
            np.testing.assert_allclose(got["loss"] - got["single_loss"],
                                       want["loss"] - want["single_loss"], atol=1e-4)
        else:
            assert abs(got["loss"] - want["single_loss"]) < 1e-2
            assert abs(got["loss"] - got["single_loss"]) < 1e-2
        assert got["placed"] and got["count"] == 1
        keys = [k for k in ref_vals if k.startswith(name + "|")]
        assert keys and sorted(keys) == sorted(k for k in vals if k.startswith(name + "|"))
        for key in keys:
            w = ref_vals[key]
            np.testing.assert_allclose(vals[key], w, rtol=1e-3,
                                       atol=1e-3 * float(np.abs(w).max()), err_msg=key)


def test_kernels_run_on_local_shards(runs):
    """zamba2 on 2 x 2: the plain attention and SSD chunk take each rank's
    shard (batch over ``data``, heads over ``model``; never the sequence).
    nemotron on 1 x 4: 6 heads do not split over 4, so attention takes every
    head and the whole sequence."""
    _, _, ports = runs
    for meta, _ in ports:
        z = meta["zamba2"]["seen"]
        # B 8 over data=2, 4 heads (and 4 KV heads) over model=2, T 32, hd 16
        assert z["attention"] and all(s == [[4, 2, 32, 16], [4, 2, 32, 16]]
                                      for s in z["attention"])
        # (B·H, T, P) with B 8 over data=2 and 8 SSD heads whole
        assert z["ssd"] and all(s == [4 * 8, 32, 16] for s in z["ssd"])
        n = meta["nemotron_14"]["seen"]
        assert n["attention"] and all(s == [[8, 6, 32, 16], [8, 2, 32, 16]]
                                      for s in n["attention"])
        y = meta["yi_tp_sp"]["seen"]
        # 4 q heads over model=2; the single KV head repeated to the q heads
        assert y["attention"] and all(s == [[4, 2, 32, 16], [4, 2, 32, 16]]
                                      for s in y["attention"])


def test_moe_drops_per_shard_as_the_reference(runs):
    """mixtral with a capacity factor of 1.0 drops slots in every dp shard;
    the meshed loss equals the reference's meshed loss (its drops, shard by
    shard) and differs from the one-device loss, whose single dispatch
    drops others."""
    _, (ref_meta, _), ports = runs
    want = ref_meta["mixtral_drops"]
    for meta, _ in ports:
        got = meta["mixtral_drops"]
        assert got["seen"]["dropped"] and min(got["seen"]["dropped"]) > 0
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        assert abs(got["loss"] - got["single_loss"]) > 1e-5
        np.testing.assert_allclose(got["single_loss"], want["single_loss"], rtol=1e-4)


@pytest.mark.parametrize("arch", INFER)
def test_forward_and_decode_on_a_mesh(runs, arch):
    """``forward`` and six ``decode_step``s over a 2 x 2 mesh (parameters,
    tokens, frames and the caches placed by the sharding rules) give the
    logits of the port without a mesh, at 1e-4 of their scale."""
    _, _, ports = runs
    for meta, _ in ports:
        got = meta[f"infer_{arch}"]
        assert got["placed"]
        assert max(got["errs"]) <= 1e-4 * max(1.0, got["scale"]), got


@pytest.mark.parametrize("arch", INFER)
def test_forward_and_decode_on_a_mesh_with_a_one_rank_model_axis(runs, arch):
    """The same over a 4 x 1 mesh, whose one-rank ``model`` axis takes the
    single token's sequence dim in decode: the logits of the port without a
    mesh, at 1e-4 of their scale."""
    _, _, ports = runs
    for meta, _ in ports:
        got = meta[f"infer41_{arch}"]
        assert got["placed"]
        assert max(got["errs"]) <= 1e-4 * max(1.0, got["scale"]), got


def test_out_proj_reduces_tp_partials_in_fp32(runs):
    """A bf16 output projection whose contraction the model axis splits: the
    product equals one device's fp32 product rounded once (the partial sums
    are formed and summed in fp32, as the reference's
    ``preferred_element_type``), and so does the gradient for its input,
    each within one bf16 ulp and equal in 99 % of the entries; the weight's
    gradient, its two data shards' bf16 partial sums added, lies within a
    few bf16 roundings of the largest entry."""
    _, _, ports = runs
    for meta, _ in ports:
        got = meta["out_proj"]
        assert got["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
        for key in ("y", "dh"):
            a, b = (np.asarray(v, np.float32) for v in got[key])
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
            assert (np.abs(a - b) <= ulp).all() and np.mean(a != b) < 0.01, key
        a, b = (np.asarray(v, np.float32) for v in got["dw"])
        assert np.abs(a - b).max() <= 2.0 ** -6 * np.abs(b).max()


def test_compressed_psum_unbiased(runs):
    """int8 transport over four gloo ranks: every rank gets the sum within
    the reference's bounds (max error < 0.1·scale + 0.2, mean error across
    five trials < 0.05·scale)."""
    _, _, ports = runs
    for meta, _ in ports:
        c = meta["compressed_psum"]
        err, scale = np.asarray(c["errs"]), c["scale"]
        assert c["dtype"] == "torch.float32" and c["shape"] == [64]
        assert np.abs(err).max() < 0.1 * scale + 0.2, np.abs(err).max()
        assert abs(err.mean()) < 0.05 * scale


def test_async_checkpointer_on_a_mesh(runs):
    """Every rank saves the placed tree; rank 0 alone writes, and the files
    are byte for byte a plain save of the whole tree."""
    tmp, _, ports = runs
    assert [m["async"]["writer"] for m, _ in ports] == [True, False, False, False]
    assert all(m["async"]["committed"] == 3 for m, _ in ports)
    plain, placed = tmp / "plain" / "step_00000003", tmp / "async" / "step_00000003"
    names = sorted(os.listdir(plain))
    assert names == sorted(os.listdir(placed))
    for n in names:
        assert (placed / n).read_bytes() == (plain / n).read_bytes(), n


def test_restore_reshards_four_ranks_onto_two(runs):
    """A checkpoint of a 2 x 2-placed leaf restores onto a 2-rank mesh as
    ``(None, "data")`` (tests/test_distributed.py::test_elastic_checkpoint_reshard)."""
    _, _, ports = runs
    for rank in (0, 1):
        e = ports[rank][0]["elastic"]
        assert e["equal"] and e["local"] == [8, 4]
        assert e["placements"] == ["S(1)"]
    assert all("elastic" not in m for m, _ in ports[2:])


def test_launch_train_mesh_under_torchrun(tmp_path):
    """``launch.train --mesh data=2,model=2 --device cpu`` on four gloo ranks
    under torchrun: a crash at step 5, a resume from the step-3 checkpoint,
    and the losses of the steps run twice equal; only rank 0 prints."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "4", "-m", "repro_torch.launch.train", "--arch",
           "yi-9b", "--smoke", "--device", "cpu", "--mesh", "data=2,model=2",
           "--steps", "8", "--crash-at", "5", "--ckpt-every", "4", "--batch", "8",
           "--seq", "32", "--log-every", "1", "--ckpt-dir", str(tmp_path / "ck")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=_env(OMP_NUM_THREADS="1"), cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    steps = re.findall(r"^step\s+(\d+) loss (\S+)", proc.stdout, re.M)
    assert [int(s) for s, _ in steps] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    losses = [float(x) for _, x in steps]
    assert losses[4] == losses[5]                 # step 4 again after the resume
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("done:")]
    assert len(done) == 1 and "failures=1" in done[0]
    from repro_torch.checkpoint import checkpoint as ck
    assert ck.latest_step(str(tmp_path / "ck")) == 7
