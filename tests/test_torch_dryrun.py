"""The multi-node dry run (``repro_torch.launch.{mesh,specs,costs,dryrun}``)
against the reference's (``repro.launch.dryrun``, ``benchmarks/hlo_analysis``).

The reference runs once, in one subprocess with 512 forced jax CPU devices
(importing ``repro.launch.dryrun`` forces them at import, so it never runs
in the pytest process): its policies, and the mode and accumulation its
``lower_cell`` chooses inline for every arch x shape (read by spying on its
``ShardEnv`` and ``make_train_step`` and stopping the cell before any
lowering); its abstract inputs at full size; rank 0's shard shapes of every
parameter and optimizer-state leaf on its (16, 16) and (2, 16, 16) meshes;
``analyze_hlo`` of the substrate loop, of a sharded product and of one
all-gather; and its own ``lower_cell``, compiled, on SMOKE configs over a
2 x 2 mesh.  The port runs the same in this process on ``meta`` tensors,
each fake process group destroyed when its test ends.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import all_arch_ids, get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_chunk  # noqa: E402
from repro_torch.launch import costs, dryrun  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.config import SHAPE_CELLS, ShapeCell  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.step import TrainState, init_state  # noqa: E402

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(all_arch_ids())
SMOKE_CELLS = [("train_4k", 64, 8, "train"), ("prefill_32k", 64, 8, "prefill"),
               ("decode_32k", 64, 8, "decode")]
MEMORY_CELLS = [("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "decode_32k")]
# one arch of each family, SMOKE-sized, on a fake 2 x 2 mesh
FAMILIES = ["qwen1.5-0.5b", "mixtral-8x7b", "mamba2-370m", "zamba2-2.7b",
            "seamless-m4t-medium", "llava-next-mistral-7b"]

_REF = r"""
import json, sys, types
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.launch.dryrun as dr
from repro.configs import all_arch_ids, get_config, get_smoke_config
from repro.core.compat import make_mesh
from repro.distributed import sharding as sh
from repro.launch import specs
from repro.models.config import SHAPE_CELLS, ShapeCell
from repro.models.model import build_model
from benchmarks.hlo_analysis import analyze_hlo

SMOKE_CELLS = {c[0]: ShapeCell(*c) for c in json.loads(sys.argv[1])}
ARCHS = sorted(all_arch_ids())
out = {}
devs = jax.devices()

def by_path(tree):
    paths, leaves, _ = sh.tree_paths(tree)
    return dict(zip(paths, leaves))

# (e) its own lower_cell on SMOKE configs over a 2 x 2 mesh
mesh22 = make_mesh((2, 2), ("data", "model"), devices=devs[:4])
real = (dr.get_config, dr.get_shape_cell, dr.make_production_mesh)
dr.get_config, dr.get_shape_cell = get_smoke_config, SMOKE_CELLS.__getitem__
dr.make_production_mesh = lambda multi_pod=False: mesh22
out["smoke"] = {}
for arch, shape in json.loads(sys.argv[2]):
    r = dr.lower_cell(arch, shape, False)
    out["smoke"][f"{arch}|{shape}"] = {"keys": sorted(r), "memory": r["memory"]}
dr.get_config, dr.get_shape_cell, dr.make_production_mesh = real

# (d) analyze_hlo: the substrate loop, a sharded product, one all-gather
def loop(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None
    return jax.lax.scan(body, x, None, length=7)[0]
f32 = jnp.float32
a, w = jax.ShapeDtypeStruct((64, 32), f32), jax.ShapeDtypeStruct((32, 32), f32)
out["loop_flops"] = analyze_hlo(jax.jit(loop).lower(a, w).compile().as_text())["flops"]
m4 = make_mesh((4,), ("model",), devices=devs[:4])
rep, col = NamedSharding(m4, P()), NamedSharding(m4, P(None, "model"))
for name, ins, o in (("col_flops", (rep, col), col), ("rep_flops", (rep, rep), rep)):
    c = jax.jit(lambda a, w: a @ w, in_shardings=ins, out_shardings=o).lower(a, w).compile()
    out[name] = analyze_hlo(c.as_text())["flops"]
c = jax.jit(lambda x: x * 1.0, in_shardings=col, out_shardings=rep).lower(a).compile()
h = analyze_hlo(c.as_text())
out["gather"] = [h["all-gather_bytes"], h["all-gather_count"]]

# (a) the policies, and the mode and accumulation lower_cell picks inline
class Stop(Exception):
    pass
seen = {}
def env_spy(**kw):
    seen["mode"] = kw["mode"]
    if seen["kind"] != "train":
        raise Stop()
    return real_cm.ShardEnv(**kw)
def step_spy(model, opt, env, accum_steps=1, **kw):
    seen["accum_steps"] = accum_steps
    raise Stop()
real_cm = dr.cm
dr.cm, dr.make_train_step = types.SimpleNamespace(ShardEnv=env_spy), step_spy
out["policy"] = {}
for arch in ARCHS:
    cfg = get_config(arch)
    for cell in SHAPE_CELLS:
        seen.clear()
        seen["kind"] = cell.kind
        try:
            dr.lower_cell(arch, cell.name, False)
        except Stop:
            pass
        out["policy"][f"{arch}|{cell.name}"] = {
            "supported": specs.cell_supported(cfg, cell)[0],
            "optimizer": dr.pick_optimizer(cfg, cfg.param_count())[1],
            "accum": list(dr.pick_accum(cfg)), "mode": seen.get("mode"),
            "accum_steps": seen.get("accum_steps")}

# (b) abstract inputs at full size
out["specs"] = {}
for arch in ARCHS:
    cfg = get_config(arch)
    model = build_model(cfg)
    for cell in SHAPE_CELLS:
        if not specs.cell_supported(cfg, cell)[0]:
            continue
        if cell.kind == "decode":
            d = specs.decode_specs(model, cell)
            tree = {"tokens": d["tokens"], "cache": d["cache"]}
        else:
            b = specs.batch_spec(cfg, cell)
            tree = {"tokens": b.tokens, "labels": b.labels, "patches": b.patches}
        out["specs"][f"{arch}|{cell.name}"] = {
            p: [list(l.shape), str(l.dtype)] for p, l in by_path(tree).items()}

# (c) rank 0's shard shape of every parameter and optimizer-state leaf
meshes = {"256": make_mesh((16, 16), ("data", "model"), devices=devs[:256]),
          "512": make_mesh((2, 16, 16), ("pod", "data", "model"), devices=devs)}
out["shards"] = {}
for arch in ARCHS:
    cfg = get_config(arch)
    params = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    opt, _ = dr.pick_optimizer(cfg, cfg.param_count())
    ostate = jax.eval_shape(opt.init, params)
    for key, mesh in meshes.items():
        ps = by_path(sh.param_shardings(params, mesh))
        os_ = by_path(sh.opt_state_shardings(ostate, params, mesh))
        out["shards"][f"{arch}|{key}"] = {
            "params": {p: list(ps[p].shard_shape(l.shape)) for p, l in by_path(params).items()},
            "opt": {p: list(os_[p].shard_shape(l.shape)) for p, l in by_path(ostate).items()}}
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def ref():
    """The reference's figures; its process starts with the first test
    and runs while the port's tests do."""
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF, json.dumps(SMOKE_CELLS),
         json.dumps(MEMORY_CELLS)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {}

    def get():
        if "out" not in box:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
            box["out"] = json.loads(out)
        return box["out"]
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun`` at full size, started with
    the first test: (process, its JSON path)."""
    out = tmp_path_factory.mktemp("dryrun") / "dr.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b",
         "--shape", "decode_32k", "--out", str(out)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(autouse=True)
def _start_children(ref, cli):
    yield


def _smoke(monkeypatch, world: int = 4):
    """lower_cell on SMOKE configs, the small cells and a 2 x 2 mesh of a
    fake group (the reference's side is patched alike)."""
    cells = {c[0]: ShapeCell(*c) for c in SMOKE_CELLS}
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "get_shape_cell", cells.__getitem__)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: lmesh.make_host_mesh((2, 2), ("data", "model")))


# -- the meta branches of the kernels' wrappers --------------------------------

ATTN_CASES = [  # (B, Hq, Hkv, Tq, Tk, D, dtype, kw)
    (2, 4, 4, 32, 32, 16, torch.float32, dict(causal=True)),
    (1, 4, 2, 48, 48, 32, torch.bfloat16, dict(causal=True, window=16)),
    (2, 8, 2, 24, 24, 16, torch.float32, dict(causal=True, softcap=30.0)),
    (2, 4, 1, 3, 40, 16, torch.bfloat16, dict(causal=False, kv_len=33)),
    (1, 2, 2, 1, 64, 64, torch.float32, dict(causal=False, window=8, kv_len=20)),
]


@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_attention_meta_branch_gives_the_plain_shapes(case):
    b, hq, hkv, tq, tk, d, dt, kw = ATTN_CASES[case]
    g = torch.Generator().manual_seed(case)
    q, k, v = (torch.randn(s, generator=g).to(dt)
               for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
    plain = flash_attention(q, k, v, **kw)
    meta = flash_attention(*(t.to("meta") for t in (q, k, v)), **kw)
    assert meta.device.type == "meta"
    assert (tuple(meta.shape), meta.dtype) == (tuple(plain.shape), plain.dtype)
    # the kernel's layout: a (B, Tq, Hq, D) buffer seen as (B, Hq, Tq, D)
    assert meta.stride() == torch.empty(b, tq, hq, d).permute(0, 2, 1, 3).stride()
    # differentiable on meta too: the gradients have the operands' shapes
    qm, km, vm = (t.to("meta").requires_grad_() for t in (q, k, v))
    grads = torch.autograd.grad(flash_attention(qm, km, vm, **kw).sum(), (qm, km, vm))
    assert [tuple(x.shape) for x in grads] == [tuple(t.shape) for t in (q, k, v)]


@pytest.mark.parametrize("bg", [4, 2, 1])
def test_ssd_meta_branch_gives_the_plain_shapes(bg):
    bh, t, p, s, chunk = 4, 32, 8, 16, 16
    g = torch.Generator().manual_seed(bg)
    x = torch.randn(bh, t, p, generator=g)
    dt = torch.rand(bh, t, generator=g)
    a = -torch.rand(bh, generator=g)
    b, c = torch.randn(bg, t, s, generator=g), torch.randn(bg, t, s, generator=g)
    plain = ssd_chunk(x, dt, a, b, c, chunk=chunk)
    meta = ssd_chunk(*(v.to("meta") for v in (x, dt, a, b, c)), chunk=chunk)
    assert [(tuple(m.shape), m.dtype, m.device.type) for m in meta] == [
        (tuple(r.shape), r.dtype, "meta") for r in plain]
    with pytest.raises(TypeError, match="f32"):
        ssd_chunk(*(v.to("meta", torch.bfloat16) for v in (x, dt, a, b, c)),
                  chunk=chunk)


def test_meta_branch_is_not_a_fallback():
    """Only meta tensors take the shape-only branch: the kernels' own entry
    points still want CUDA tensors, and the meta one meta tensors."""
    q = torch.zeros(1, 2, 8, 16)
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk.flash_attention(q, q, q, causal=True, window=0, softcap=0.0, sm_scale=0.25)
    with pytest.raises(ValueError, match="META tensors"):
        fk.flash_attention_meta(q, q, q)
    x = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.ssd_chunk(x, torch.zeros(2, 16), torch.zeros(2), torch.zeros(2, 16, 8),
                     torch.zeros(2, 16, 8), chunk=16)
    assert fk.flash_attention.launches == 0 and sk.ssd_chunk.launches == 0


# -- the mesh ------------------------------------------------------------------

def test_production_meshes_on_fake_groups():
    for multi_pod, shape, names in ((False, (32, 8), ("data", "model")),
                                    (True, (2, 32, 8), ("pod", "data", "model"))):
        with lmesh.fake_process_group(512 if multi_pod else 256):
            m = lmesh.make_production_mesh(multi_pod=multi_pod)
            assert (tuple(m.shape), m.mesh_dim_names, m.device_type) == (shape, names, "cuda")
            assert lmesh.dp_axes(multi_pod) == names[:-1]
            host = lmesh.make_host_mesh()
            assert tuple(host.shape) == (1, 512 if multi_pod else 256)
            with pytest.raises(ValueError, match="holds 4 ranks"):
                lmesh.make_host_mesh((2, 2), ("data", "model"))
            with pytest.raises(RuntimeError, match="already initialised"):
                with lmesh.fake_process_group(4):
                    pass
    import torch.distributed as dist
    assert not dist.is_initialized()


# -- (a) the policies ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_policies_match_reference(arch, ref):
    cfg = get_config(arch)
    for cell in SHAPE_CELLS:
        want = ref()["policy"][f"{arch}|{cell.name}"]
        assert specs.cell_supported(cfg, cell)[0] == want["supported"]
        assert dryrun.pick_optimizer(cfg, cfg.param_count())[1] == want["optimizer"]
        assert list(dryrun.pick_accum(cfg)) == want["accum"]
        if not want["supported"]:
            continue
        # the reference's 256 devices: mode over all ranks, accumulation
        # halved for its 16-way data axis
        assert dryrun.pick_mode(cfg, cell, 256) == want["mode"], cell.name
        if cell.kind == "train":
            assert dryrun.fit_accum(dryrun.pick_accum(cfg)[0], cell.global_batch,
                                    16) == want["accum_steps"]


def test_mode_read_from_lower_cell_matches(ref):
    """The mode the port's own lower_cell records, on its production mesh
    (the same 256 ranks), against the reference's inline choice."""
    with lmesh.fake_process_group(256):
        for arch in ("qwen1.5-0.5b", "zamba2-2.7b"):
            r = dryrun.lower_cell(arch, "train_4k", False, compile_=False)
            assert r["status"] == "lowered"
            assert r["mode"] == ref()["policy"][f"{arch}|train_4k"]["mode"]


# -- (b) the abstract inputs -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, ref):
    cfg = get_config(arch)
    model = build_model(cfg)
    for cell in SHAPE_CELLS:
        key = f"{arch}|{cell.name}"
        if not specs.cell_supported(cfg, cell)[0]:
            assert key not in ref()["specs"]
            with pytest.raises(ValueError, match="skipped"):
                specs.input_specs(cfg, cell.name)
            continue
        if cell.kind == "decode":
            d = specs.decode_specs(model, cell)
            tree = {"tokens": d["tokens"], "cache": d["cache"]}
        else:
            b = specs.batch_spec(cfg, cell)
            tree = {"tokens": b.tokens, "labels": b.labels, "patches": b.patches}
        paths, leaves, _ = shlib.tree_paths(tree)
        got = dict(zip(paths, leaves))
        want = dict(ref()["specs"][key])
        # the one term that differs: the port keeps a cache's position on
        # the host (a Python int), the reference in an int32 scalar array
        if cell.kind == "decode":
            assert got.pop("cache/pos") == 0 and want.pop("cache/pos") == [[], "int32"]
        assert sorted(got) == sorted(want), key
        for p, leaf in got.items():
            assert leaf.device.type == "meta"
            assert [list(leaf.shape), str(leaf.dtype).replace("torch.", "")] == want[p], (key, p)


# -- (c) rank 0's shards -----------------------------------------------------------

def _local_shapes(tree):
    from repro_torch.core import placement as _pl
    paths, leaves, _ = shlib.tree_paths(tree)
    return {p: list(_pl.local(l).shape) for p, l in zip(paths, leaves)
            if isinstance(l, torch.Tensor)}


@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_shards_match_reference(arch, ref):
    cfg = get_config(arch)
    opt, _ = dryrun.pick_optimizer(cfg, cfg.param_count())
    state = init_state(build_model(cfg), opt, torch.Generator(), "meta")
    for key, shape, names in (("256", (16, 16), ("data", "model")),
                              ("512", (2, 16, 16), ("pod", "data", "model"))):
        with lmesh.fake_process_group(int(key)):
            m = lmesh.make_host_mesh(shape, names)
            placed = shlib.distribute(state, TrainState(
                params=shlib.param_shardings(state.params, m),
                opt_state=shlib.opt_state_shardings(state.opt_state, state.params, m)))
        want = ref()["shards"][f"{arch}|{key}"]
        assert _local_shapes(placed.params) == want["params"], key
        assert _local_shapes(placed.opt_state) == want["opt"], key


# -- (d) the costs -------------------------------------------------------------------

def test_costs_count_the_substrate_loop(ref):
    def loop(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x
    for dev in ("cpu", "meta"):
        r = costs.analyze(loop, torch.ones(64, 32, device=dev), torch.ones(32, 32, device=dev))
        assert r["flops"] == 7 * 2 * 64 * 32 * 32 == ref()["loop_flops"]
        assert r["hbm_bytes"] > 7 * 64 * 32 * 4         # at least the activations
        assert r["collective_bytes"] == 0


def test_costs_are_per_rank_on_a_fake_mesh(ref):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.core import placement as _pl
    with lmesh.fake_process_group(4):
        m = lmesh.make_host_mesh((4,), ("model",))
        a = _pl.place(torch.empty(64, 32, device="meta"), m, (Replicate(),))
        w = torch.empty(32, 32, device="meta")
        col = costs.analyze(lambda: a @ _pl.place(w, m, (Shard(1),)))
        rep = costs.analyze(lambda: a @ _pl.place(w, m, (Replicate(),)))
        x = _pl.place(torch.empty(64, 32, device="meta"), m, (Shard(1),))
        gather = costs.analyze(lambda: x.redistribute(m, (Replicate(),)))
    assert col["flops"] == 2 * 64 * 32 * 32 / 4 == ref()["col_flops"]
    assert rep["flops"] == 2 * 64 * 32 * 32 == ref()["rep_flops"]
    assert [gather["all-gather_bytes"], gather["all-gather_count"]] == ref()["gather"]
    assert gather["collective_bytes"] == gather["all-gather_bytes"] == 64 * 32 * 4
    assert gather["top_collective_sites"][0]["bytes"] == 64 * 32 * 4


def test_collectives_by_mesh_axis():
    """Each collective's bytes go to the mesh axes its group spans: a gather
    over ``model`` (NVLink on H100 nodes) apart from one over ``data``, and
    one over both dims at once (a flattened group) under ``data+model``."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.core import placement as _pl
    with lmesh.fake_process_group(8):
        m = lmesh.make_host_mesh((2, 4), ("data", "model"))
        x = _pl.place(torch.empty(64, 32, device="meta"), m, (Shard(0), Shard(1)))
        both = m["data", "model"]._flatten("dp_tp")
        y = _pl.place(torch.empty(64, 32, device="meta"), both, (Shard(0),))
        r = costs.analyze(lambda: x.redistribute(m, (Replicate(), Replicate())), mesh=m)
        flat = costs.analyze(lambda: y.redistribute(both, (Replicate(),)), mesh=m)
    # rank 0 gathers (32, 32) over model, then (64, 32) over data
    assert r["collective_bytes_by_axis"] == {"model": 32 * 32 * 4, "data": 64 * 32 * 4}
    assert sum(r["collective_bytes_by_axis"].values()) == r["collective_bytes"]
    assert {s["axes"] for s in r["top_collective_sites"]} == {"model", "data"}
    assert flat["collective_bytes_by_axis"] == {"data+model": 64 * 32 * 4}


def test_costs_count_kernel_calls_by_their_formula():
    q = torch.empty(2, 4, 32, 16, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 2, 32, 16, device="meta", dtype=torch.bfloat16)
    r = costs.analyze(lambda: flash_attention(q, k, k, causal=True, window=8))
    pairs = costs.attention_pairs(32, 32, causal=True, window=8)
    assert pairs == 8 * 9 // 2 + 24 * 8
    assert r["flops"] == 4 * 2 * 4 * pairs * 16
    assert r["hbm_bytes"] == 2 * q.numel() * 2 + 2 * k.numel() * 2
    assert costs.attention_pairs(1, 64, causal=False, window=0, kv_len=20) == 20
    assert costs.attention_pairs(4, 8, causal=True, window=0, q_offset=4) == 5 + 6 + 7 + 8


# -- (e) the memory ------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", MEMORY_CELLS)
def test_argument_bytes_match_reference(arch, shape, ref, monkeypatch):
    _smoke(monkeypatch)
    with lmesh.fake_process_group(4):
        r = dryrun.lower_cell(arch, shape, False)
    assert r["status"] == "ok"
    want = ref()["smoke"][f"{arch}|{shape}"]["memory"]["argument_bytes"]
    got = r["memory"]["argument_bytes"]
    if shape == "train_4k":
        assert got == want
    else:
        # the one term that differs: the cache's position, an int32 scalar
        # array in the reference, a Python int on the host in the port
        assert got == want - 4
    m = r["memory"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"] > m["argument_bytes"]


# -- the cells ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_cells_of_every_family(arch, ref, monkeypatch):
    _smoke(monkeypatch)
    keys = set(ref()["smoke"]["qwen1.5-0.5b|train_4k"]["keys"])
    with lmesh.fake_process_group(4):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            r = dryrun.lower_cell(arch, shape, False)
            assert r["status"] == "ok", (arch, shape)
            want = keys if shape == "train_4k" else keys - {"optimizer", "accum_steps", "mode"}
            # nothing is compiled: ``trace_s`` stands where ``compile_s`` was
            assert want - {"compile_s"} <= set(r), (arch, shape)
            assert r["hlo"]["flops"] > 0 and r["memory"]["peak_bytes"] > 0
            assert set(r["hlo"]) >= {"hbm_bytes", "hbm_bytes_fused", "collective_bytes",
                                     "all-gather_bytes", "all-to-all_count",
                                     "top_collective_sites"}


def test_fewer_sequences_than_data_ranks():
    """A prefill of 2 sequences over 4 data ranks: the batch replicates and
    the MoE layer routes 4 token shards, then gathers them to view (B, T)
    again."""
    cell = ShapeCell("prefill_32k", 64, 2, "prefill")
    with lmesh.fake_process_group(4):
        m = lmesh.make_host_mesh((4, 1), ("data", "model"))
        r = dryrun.estimate(get_smoke_config("mixtral-8x7b"), cell, mesh=m)
    assert r["hlo"]["all-gather_count"] > 0 and r["memory"]["peak_bytes"] > 0


@pytest.mark.parametrize("arch", ["yi-9b", "llava-next-mistral-7b", "mixtral-8x7b",
                                  "grok-1-314b", "mamba2-370m", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_meshes_with_a_one_rank_axis(arch):
    """Prefill and decode of one sequence over a (1, 4) mesh and of four
    over a (4, 1) one: a dim of size 1 (the batch, the decoded token's
    sequence) placed on a one-rank axis is replicated before DTensor flattens
    it, in every family."""
    for shape, b in (((1, 4), 1), ((4, 1), 4)):
        for kind in ("prefill", "decode"):
            with lmesh.fake_process_group(4):
                m = lmesh.make_host_mesh(shape, ("data", "model"))
                r = dryrun.estimate(get_smoke_config(arch), ShapeCell(kind, 64, b, kind), mesh=m)
            assert r["memory"]["peak_bytes"] > 0, (shape, kind)


def test_cli_at_full_size(cli):
    proc, out = cli
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stdout + stderr
    assert "[ok     ] qwen1.5-0.5b x decode_32k x 1pod flops/dev=" in stdout
    assert "done: 1 cells, 0 errors" in stdout
    (r,) = json.loads(out.read_text())
    assert r["status"] == "ok" and r["chips"] == 256 and r["kind"] == "decode"
    assert 0 < r["memory"]["peak_bytes"] < 80e9


def test_a_cell_that_raises_is_an_error(monkeypatch, capsys):
    def broken(*a, **k):
        def step(state, batch):
            raise RuntimeError("step broke")
        return step
    monkeypatch.setattr(dryrun, "make_train_step", broken)
    _smoke(monkeypatch)
    monkeypatch.setattr(dryrun, "fake_process_group", lambda n: lmesh.fake_process_group(4))
    rc = dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k",
                      "--out", os.devnull])
    text = capsys.readouterr().out
    assert rc == 1
    assert "[error  ] qwen1.5-0.5b x train_4k x 1pod step broke" in text
    assert "done: 1 cells, 1 errors" in text
    import torch.distributed as dist
    assert not dist.is_initialized()
