"""The port's distribution layer against the reference's, on the CPU.

The same seeded NumPy inputs go through ``repro.core.shmap_ops`` and
``DsArray.distribute`` on four jax CPU devices (one subprocess with
``--xla_force_host_platform_device_count=4``, as ``tests/test_distributed.py``
runs them) and through ``repro_torch.core.shmap_ops`` on four gloo ranks
(four processes that meet at a ``FileStore`` under ``tmp_path``), on 2 x 2,
4 x 1 and 1 x 4 meshes.  Every case of :func:`_cases` is compared on every
rank: values (rtol = atol = 1e-4 for floats, exact for permutations and
selections), shape, dtype, ``pad_state``, padded grid, ``block_format``, and
the placement of the reference's sharding.  The estimators (K-means, PCA,
Ridge), ``io.save_blocks`` and ``checkpoint.save`` of a distributed array
are cases too, compared as host arrays (labels and file bytes exactly).  A
one-rank gloo group in this process holds ``distribute_sparse``, the
estimators, the spill and the checkpoint to the reference's one-device
mesh, lazy plans over a distributed array to their eager results, and
checks that no kernel wrapper takes a DTensor.
"""

import importlib
import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as pt  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.core.compat import AxisType, make_mesh  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TOL = dict(rtol=1e-4, atol=1e-4)
WORLD = 4


def _cases(pkg, so, fa, meshes, files=None):
    """name -> thunk over one package (``pkg``: ``repro.core`` or
    ``repro_torch``; ``so``: its ``shmap_ops``; ``fa``: its ``from_array``;
    ``meshes``: ``{"22": (2, 2), "41": (4, 1), "14": (1, 4)}`` meshes over
    the axes ``("data", "model")``; ``files``: a directory every rank
    sees)."""
    rng = np.random.default_rng(20261017)
    x = rng.normal(size=(36, 50)).astype(np.float32)   # grid 5 x 7: ragged
    y = rng.normal(size=(50, 20)).astype(np.float32)
    z = rng.normal(size=(64, 64)).astype(np.float32)
    A, B, Z = fa(x, (8, 8)), fa(y, (8, 8)), fa(z, (8, 8))
    m22 = meshes["22"]
    out = {}
    for tag, m in meshes.items():
        out[f"summa_{tag}"] = lambda m=m: so.summa_matmul(A, B, m)
        out[f"cannon_{tag}"] = lambda m=m: so.cannon_matmul(A, B, m)
        out[f"transpose_pp_{tag}"] = lambda m=m: so.transpose_pp(A, m)
        out[f"colsum_psum_{tag}"] = lambda m=m: so.colsum_psum(A, m)
    # FILL-pad operands: matmul re-zeroes, transpose carries the pad state
    out["summa_fill"] = lambda: so.summa_matmul(A + 1.0, B - 2.0, m22)
    out["cannon_fill"] = lambda: so.cannon_matmul(A + 1.0, B - 2.0, m22)
    out["transpose_pp_fill"] = lambda: so.transpose_pp(A + 1.0, m22)
    out["transpose_pp_fill_sum"] = lambda: so.transpose_pp(A + 1.0, m22).sum()
    out["colsum_psum_fill"] = lambda: so.colsum_psum(A + 1.0, m22)
    out["slice_sharded_rows"] = lambda: so.slice_sharded(
        A, (slice(3, 30), slice(None)), m22)
    out["slice_sharded_cols"] = lambda: so.slice_sharded(
        A, (slice(None), slice(8, 41)), m22)
    out["rechunk_sharded"] = lambda: so.rechunk_sharded(A, (4, 4), m22)
    out["rechunk_sharded_gather"] = lambda: so.rechunk_sharded(A, (6, 10), m22)
    out["concat_rows_sharded"] = lambda: so.concat_rows_sharded([A, A[:20]], m22)
    # tests/test_distributed.py::test_structural_ops_preserve_sharding
    zd = lambda: Z.distribute(m22)
    out["distribute"] = zd
    out["grid_slice"] = lambda: zd()[16:48, 0:32]
    out["rechunk"] = lambda: zd().rechunk((4, 4))
    out["concat_rows"] = lambda: pkg.concat_rows([zd(), zd()])
    out["filter"] = lambda: zd()[np.arange(1, 64, 2)]
    # the ragged grid through the plain ops of a distributed array
    ad = lambda: A.distribute(m22)
    out["ragged_distribute"] = ad
    out["ragged_slice"] = lambda: ad()[8:32]
    out["ragged_filter"] = lambda: ad()[np.arange(1, 36, 2)]
    out["ragged_rechunk"] = lambda: ad().rechunk((6, 10))
    out["ragged_add"] = lambda: ad() + 1.0
    out["ragged_mul"] = lambda: ad() * ad()
    out["ragged_mixed"] = lambda: ad() - A
    out["ragged_neg_sqrt"] = lambda: (-ad()).abs().sqrt()
    out["ragged_T"] = lambda: ad().T
    out["ragged_sum0"] = lambda: ad().sum(axis=0)
    out["ragged_sum1"] = lambda: ad().sum(axis=1)
    out["ragged_sum"] = lambda: ad().sum()
    out["ragged_max0"] = lambda: ad().max(axis=0)
    out["ragged_mean1"] = lambda: ad().mean(axis=1)
    out["ragged_matmul"] = lambda: ad() @ B.distribute(m22)
    out["ragged_T_matmul"] = lambda: ad().T @ ad()
    out["ragged_T_add"] = lambda: ad().T + A.T
    out["ragged_matmul_ta"] = lambda: pkg.matmul_ta(ad(), ad())
    out["ragged_norm1"] = lambda: ad().norm(axis=1)
    out["ragged_gram"] = lambda: pkg.gram(ad())
    out["replicated_axis"] = lambda: A.distribute(m22, ("data", None))
    out["replicated_axis_scale"] = lambda: A.distribute(m22, ("data", None)) * 2.0
    out["replicated_axis_sum1"] = lambda: A.distribute(m22, ("data", None)).sum(axis=1)
    # the estimators, the spill and the checkpoint of a distributed array
    # (ROADMAP.md §3), as host arrays
    yv = rng.normal(size=(36, 1)).astype(np.float32)
    q0 = rng.normal(size=(50, 2)).astype(np.float32)
    fitted = {}

    def mod(name):
        return importlib.import_module(pkg.__name__.split(".")[0] + "." + name)

    def host(v):
        return np.asarray(v.collect() if hasattr(v, "collect") else v)

    def fit(kind, tag):
        if (kind, tag) not in fitted:
            x = A.distribute(meshes[tag])
            if kind == "kmeans":
                est = mod("algorithms.kmeans").KMeans(n_clusters=3, max_iter=3)
                est.fit(x)
            elif kind == "ridge":
                est = mod("estimators.linear").Ridge(alpha=0.1)
                est.fit(x, fa(yv, (8, 1)).distribute(meshes[tag], ("data", None)))
            else:       # PCA from one start in both packages
                lin = mod("algorithms.linalg")
                if pkg.__name__ == "repro_torch":
                    import torch
                    owner, name = lin, "_initial_q"
                    start = lambda m_, k_, seed, device: torch.as_tensor(q0, device=device)
                else:
                    import jax.numpy as jnp
                    owner, name = lin.jax.random, "normal"
                    start = lambda key, shape, *a, **kw: jnp.asarray(q0)
                saved = getattr(owner, name)
                setattr(owner, name, start)
                try:
                    est = lin.PCA(n_components=2).fit(x)
                finally:
                    setattr(owner, name, saved)
            fitted[kind, tag] = est
        return fitted[kind, tag]

    def pca_signs(tag):
        comps = host(fit("pca", tag).components_)
        return np.sign(comps[np.arange(len(comps)), np.abs(comps).argmax(1)])

    def spill(tag, a):
        d = os.path.join(files, f"spill_{tag}")
        mod("core.io").save_blocks(d, a)
        return np.frombuffer(b"".join(open(os.path.join(d, f), "rb").read()
                                      for f in sorted(os.listdir(d))), np.uint8)

    def checkpointed(tag):
        ck = mod("checkpoint.checkpoint")
        leaf = A.distribute(meshes[tag]).blocks
        d = os.path.join(files, f"ckpt_{tag}")
        ck.save(d, 0, {"w": leaf})
        kw = {"device": "cpu"} if pkg.__name__ == "repro_torch" else {}
        back = ck.restore(d, 0, {"w": np.zeros(leaf.shape, np.float32)}, **kw)
        return host(back["w"])

    for tag in meshes:
        out[f"save_blocks_{tag}"] = lambda tag=tag: spill(tag, A.distribute(meshes[tag]))
        out[f"checkpoint_{tag}"] = lambda tag=tag: checkpointed(tag)
    # the estimators on the meshes that shard both grid dims and the rows
    # alone (the reference compiles each fit per mesh: the file's time)
    for tag in ("22", "41"):
        out[f"kmeans_fit_{tag}"] = lambda tag=tag: host(fit("kmeans", tag).centers_)
        out[f"kmeans_predict_{tag}"] = lambda tag=tag: host(
            fit("kmeans", tag).predict(A.distribute(meshes[tag])))
        out[f"kmeans_score_{tag}"] = lambda tag=tag: fit("kmeans", tag).score(
            A.distribute(meshes[tag]))
        out[f"pca_fit_{tag}"] = lambda tag=tag: np.concatenate([
            (host(fit("pca", tag).components_) * pca_signs(tag)[:, None]).ravel(),
            host(fit("pca", tag).explained_variance_), host(fit("pca", tag).mean_).ravel()])
        out[f"pca_transform_{tag}"] = lambda tag=tag: host(
            fit("pca", tag).transform(A.distribute(meshes[tag]))) * pca_signs(tag)
        out[f"ridge_fit_{tag}"] = lambda tag=tag: np.append(
            host(fit("ridge", tag).coef_), fit("ridge", tag).intercept_).astype(np.float32)
        out[f"ridge_predict_{tag}"] = lambda tag=tag: host(
            fit("ridge", tag).predict(A.distribute(meshes[tag])))
    # a grid every mesh divides: the spill of the distributed array is the
    # undistributed array's, byte for byte
    out["save_blocks_even"] = lambda: spill("even", Z.distribute(m22))
    out["save_blocks_even_plain"] = lambda: spill(f"even_plain_{os.getpid()}", Z)
    return out


CASE_NAMES = list(_cases(None, None, lambda *a: None,
                         dict.fromkeys(("22", "41", "14"))))
# permutations, selections and exact IEEE arithmetic: equal bits
EXACT = {"distribute", "grid_slice", "filter", "ragged_distribute", "ragged_slice",
         "ragged_filter", "ragged_rechunk", "ragged_add", "ragged_T",
         "replicated_axis", "replicated_axis_scale"}
EXACT_PREFIXES = ("transpose_pp", "slice_sharded", "rechunk", "concat_rows",
                  "kmeans_predict", "save_blocks", "checkpoint")
# where the port's placement is its own, documented choice (values, shape,
# pad state as the reference's; grid the reference's rounded up to the
# mesh): the reference drops its sharding for a new grid that does not
# divide the mesh, and the port keeps the operand's placement; for the
# products and apply_along_axis the reference lets XLA place the result,
# and the port places it as its operand (SUMMA on the operand's axes,
# mirrored for a transposed operand)
PORT_PLACED = {"ragged_slice": "S0,S1", "ragged_filter": "S0,S1",
               "ragged_rechunk": "S0,S1", "ragged_T_matmul": "S1,S0",
               "ragged_matmul_ta": "S0,S1", "ragged_norm1": "S0,S1"}

_RECORD = """
def record(out, place):
    if isinstance(out, np.ndarray):
        return {"value": out}, {"array": True, "shape": list(out.shape),
                                "dtype": str(out.dtype)}
    if not hasattr(out, "grid"):
        return {"value": np.asarray(out, dtype=np.float64)}, {"scalar": True}
    leaf = out.blocks.data if out.block_format == "bcoo" else out.blocks
    meta = {"shape": list(out.shape), "grid": list(out.stacked_grid),
            "format": out.block_format, "dtype": str(out.dtype).replace("torch.", ""),
            "pad": [out.pad_state.kind, out.pad_state.fill], "place": place(leaf)}
    return {"value": np.asarray(out.collect(), dtype=np.float64)}, meta


def run_all(cases, place, prefix):
    arrays, metas = {}, {}
    for name, thunk in cases.items():
        try:
            out = thunk()
        except Exception as e:
            metas[name] = {"error": type(e).__name__ + ": " + str(e)}
            continue
        vals, meta = record(out, place)
        metas[name] = meta
        arrays[name] = vals["value"]
    np.savez(prefix + ".npz", **arrays)
    with open(prefix + ".json", "w") as f:
        json.dump(metas, f)
"""

_REF = """
import importlib, json, os, sys
import numpy as np
from repro import core as pkg
from repro.core import shmap_ops as so
from repro.core.compat import make_mesh
{record}
{cases}

def place(leaf):
    spec = tuple(leaf.sharding.spec) + (None, None)
    return ",".join("S0" if spec[0] == n else "S1" if spec[1] == n else "R"
                    for n in ("data", "model"))

meshes = {{"22": make_mesh((2, 2), ("data", "model")),
          "41": make_mesh((4, 1), ("data", "model")),
          "14": make_mesh((1, 4), ("data", "model"))}}
files = sys.argv[1] + "_files"
os.makedirs(files)
run_all(_cases(pkg, so, pkg.from_array, meshes, files), place, sys.argv[1])
"""

_RANK = """
import importlib, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, prefix = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
import repro_torch as pkg
from repro_torch.core import shmap_ops as so
from repro_torch.core.compat import make_mesh
{record}
{cases}

def place(leaf):
    return ",".join("R" if p.is_replicate() else f"S{{p.dim}}"
                    for p in leaf.placements)

meshes = {{k: make_mesh(s, ("data", "model"), device_type="cpu")
          for k, s in (("22", (2, 2)), ("41", (4, 1)), ("14", (1, 4)))}}
fa = lambda a, bs: pkg.from_array(a, bs, device="cpu")
files = os.path.join(os.path.dirname(prefix), "port_files")
os.makedirs(files, exist_ok=True)
run_all(_cases(pkg, so, fa, meshes, files), place, prefix)
dist.barrier()
dist.destroy_process_group()
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(ROOT), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


def _script(tmp, name, template):
    path = tmp / name
    path.write_text(template.format(record=_RECORD,
                                    cases=textwrap.dedent(inspect.getsource(_cases))))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference (one process, four jax devices) beside the port
    (four gloo ranks), all at once; load what each wrote."""
    tmp = tmp_path_factory.mktemp("distributed")
    procs = [("reference", subprocess.Popen(
        [sys.executable, _script(tmp, "ref.py", _REF), str(tmp / "ref")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu")))]
    rank_py = _script(tmp, "rank.py", _RANK)
    for r in range(WORLD):
        procs.append((f"rank {r}", subprocess.Popen(
            [sys.executable, rank_py, str(r), str(WORLD), str(tmp / "store"),
             str(tmp / f"rank{r}")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(OMP_NUM_THREADS="1"))))
    logs = {}
    try:
        for name, p in procs:
            logs[name] = p.communicate(timeout=300)[0]
    finally:
        for _, p in procs:
            p.kill()
    for name, p in procs:
        assert p.returncode == 0, f"{name} failed:\n{logs[name][-4000:]}"

    def load(prefix):
        meta = json.loads((tmp / f"{prefix}.json").read_text())
        with np.load(tmp / f"{prefix}.npz") as z:
            return meta, {k: z[k] for k in z.files}
    return load("ref"), [load(f"rank{r}") for r in range(WORLD)]


def _round_up(a, b):
    return -(-a // b) * b


@pytest.mark.parametrize("name", CASE_NAMES)
def test_case_matches_reference(runs, name):
    (ref_meta, ref_vals), ports = runs
    want = ref_meta[name]
    for rank, (meta, vals) in enumerate(ports):
        got = meta[name]
        if "error" in want:
            # the reference refuses (a non-square mesh for Cannon and
            # transpose_pp): the port refuses with the same error type
            assert "error" in got, (rank, got)
            assert got["error"].split(":")[0] == want["error"].split(":")[0]
            continue
        assert "error" not in got, (rank, got["error"])
        if want.get("array"):
            assert (got["shape"], got["dtype"]) == (want["shape"], want["dtype"]), \
                (rank, got, want)
            if name.startswith(EXACT_PREFIXES):
                np.testing.assert_array_equal(vals[name], ref_vals[name])
            else:
                np.testing.assert_allclose(vals[name], ref_vals[name], **TOL)
            continue
        if want.get("scalar"):
            np.testing.assert_allclose(vals[name], ref_vals[name], rtol=1e-4,
                                       atol=1e-3)
            continue
        for key in ("shape", "format", "dtype", "pad"):
            assert got[key] == want[key], (rank, key, got[key], want[key])
        if name in PORT_PLACED:
            assert want["place"] != PORT_PLACED[name]
            assert got["place"] == PORT_PLACED[name], (rank, got["place"])
            assert got["grid"] == [_round_up(want["grid"][0], 2),
                                   _round_up(want["grid"][1], 2)]
        else:
            assert got["place"] == want["place"], (rank, got["place"], want["place"])
            assert got["grid"] == want["grid"], (rank, got["grid"], want["grid"])
        if name in EXACT or name.startswith(EXACT_PREFIXES):
            np.testing.assert_array_equal(vals[name], ref_vals[name])
        else:
            np.testing.assert_allclose(vals[name], ref_vals[name], **TOL)


def test_cases_cover_the_schedules_and_the_structural_ops(runs):
    """Every shmap_ops function and structural op ran on the 2 x 2 mesh;
    the square-mesh schedules refused the 4 x 1 and 1 x 4 meshes."""
    (ref_meta, _), ports = runs
    for meta, _ in [(ref_meta, None)] + ports:
        for fn in ("summa", "cannon", "transpose_pp", "colsum_psum"):
            assert "error" not in meta[f"{fn}_22"]
        for tag in ("41", "14"):
            assert "error" not in meta[f"summa_{tag}"]
            assert "error" not in meta[f"colsum_psum_{tag}"]
            assert "ValueError" in meta[f"cannon_{tag}"]["error"]
            assert "ValueError" in meta[f"transpose_pp_{tag}"]["error"]
    assert all(ref_meta[n]["place"] == "S0,S1"
               for n in ("distribute", "grid_slice", "rechunk", "concat_rows",
                         "filter", "summa_22", "cannon_22", "transpose_pp_22"))
    assert ref_meta["colsum_psum_22"]["place"] == "R,S1"
    assert ref_meta["replicated_axis"]["place"] == "S0,R"
    # the estimators, the spill and the checkpoint ran on every mesh
    for meta, _ in [(ref_meta, None)] + ports:
        for name in CASE_NAMES:
            if name.startswith(("kmeans_", "pca_", "ridge_", "save_blocks",
                                "checkpoint")):
                assert "error" not in meta[name], (name, meta[name])


def test_spill_of_a_distributed_array_is_the_undistributed_ones(runs):
    """On a grid the mesh divides, ``save_blocks`` of the distributed array
    writes the bytes the undistributed array writes, in both packages."""
    (ref_meta, ref_vals), ports = runs
    plain = ref_vals["save_blocks_even_plain"]
    np.testing.assert_array_equal(ref_vals["save_blocks_even"], plain)
    for meta, vals in ports:
        np.testing.assert_array_equal(vals["save_blocks_even"], plain)


# ---------------------------------------------------------------------------
# One rank in this process
# ---------------------------------------------------------------------------


def test_make_mesh_without_a_process_group_raises():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1), ("data", "model"), device_type="cpu")


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group and a 1 x 1 ``("data", "model")`` mesh."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu",
                        axis_types=(AxisType.Auto,) * 2)
    finally:
        dist.destroy_process_group()


def test_make_mesh_checks_its_arguments(one_rank):
    with pytest.raises(ValueError, match="holds 4 ranks"):
        make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with pytest.raises(ValueError, match="nccl"):
        make_mesh((1, 1), ("data", "model"), device_type="cuda")
    with pytest.raises(ValueError, match="axis types"):
        make_mesh((1, 1), ("data", "model"), device_type="cpu",
                  axis_types=(AxisType.Auto,))
    assert one_rank.mesh_dim_names == ("data", "model")


def test_distribute_sparse_single_rank(one_rank):
    """The counterpart of ``tests/test_sparse.py::
    test_distribute_sparse_single_device``, held to the reference's."""
    import jax
    import scipy.sparse as sp
    from jax.sharding import Mesh
    import repro.core as jx
    mat = sp.random(12, 8, density=0.3, format="csr", random_state=7,
                    dtype=np.float32)
    ref = jx.from_scipy(mat, (4, 4)).distribute(
        Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model")))
    s = pt.from_scipy(mat, (4, 4), device="cpu")
    placed = s.distribute(one_rank)
    assert placed.block_format == ref.block_format == "bcoo"
    assert placed.is_distributed
    assert placement.is_dtensor(placed.blocks.indices)
    assert placed.stacked_grid == tuple(ref.stacked_grid)
    assert placed.blocks.nse == ref.blocks.nse
    placed.check_invariants()
    np.testing.assert_allclose(placed.collect().numpy(), np.asarray(ref.collect()))
    dense = placed.todense()
    assert dense.block_format == "dense" and dense.is_distributed
    np.testing.assert_allclose(dense.collect().numpy(), mat.toarray())
    twice = placed * 2.0
    assert twice.block_format == "bcoo" and twice.is_distributed
    np.testing.assert_allclose(twice.collect().numpy(), 2 * mat.toarray())


def _wrappers():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.kmeans import ops as ko
    from repro_torch.kernels.matmul import kernel as mk
    from repro_torch.kernels.matmul import ops as mo
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ops as so
    f32 = torch.float32
    return {
        "local_matmul": lambda d: mo.local_matmul(d, d),
        "stacked_matmul": lambda d: mk.stacked_matmul(d, d, out_dtype=f32),
        "kmeans_assign_stacked": lambda d: ko.kmeans_assign_stacked(
            d, torch.zeros(3, 2), 2),
        "kmeans_assign": lambda d: ko.kmeans_assign(d[0, 0], torch.zeros(3, 2)),
        "kmeans_kernel": lambda d: kk.kmeans_assign_stacked(d, torch.zeros(3, 2), 2),
        "flash_attention": lambda d: fo.flash_attention(d, d, d),
        "flash_attention_kernel": lambda d: fk.flash_attention(
            d, d, d, causal=True, window=0, softcap=0.0, sm_scale=1.0,
            q_offset=0, kv_len=None),
        "ssd_chunk": lambda d: so.ssd_chunk(d[0], d[0, :, :, 0], d[0, 0, 0],
                                            d[0], d[0], chunk=2),
        "ssd_scan": lambda d: so.ssd_scan(d[0], d[0, :, :, 0], d[0, 0, 0],
                                          d[0], d[0], chunk=2),
        "ssd_kernel": lambda d: sk.ssd_chunk(d[0], d[0, :, :, 0], d[0, 0, 0],
                                             d[0], d[0], chunk=2),
    }


@pytest.mark.parametrize("wrapper", list(_wrappers()))
def test_no_kernel_wrapper_takes_a_dtensor(one_rank, wrapper):
    """A DTensor's ``data_ptr()`` is 0: every wrapper refuses one, on any
    device, before it reads a pointer or picks the plain version."""
    d = pt.from_array(np.ones((4, 4), np.float32), (2, 2),
                      device="cpu").distribute(one_rank).blocks
    assert placement.is_dtensor(d) and d.data_ptr() == 0
    with pytest.raises(TypeError, match="DTensor"):
        _wrappers()[wrapper](d)


def test_matmul_of_distributed_arrays_never_hands_a_dtensor_to_the_kernel(
        one_rank, monkeypatch):
    """``@`` runs summa_matmul (``local_matmul`` sees each rank's shard) and
    ``matmul_ta`` the gathered operands; both keep the mesh."""
    from repro_torch.kernels.matmul import ops
    seen = []
    real = ops.local_matmul

    def spy(a, b, **kw):
        seen.append((type(a).__name__, type(b).__name__))
        return real(a, b, **kw)
    monkeypatch.setattr(ops, "local_matmul", spy)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20, 12)).astype(np.float32)
    y = rng.normal(size=(12, 9)).astype(np.float32)
    A = pt.from_array(x, (8, 4), device="cpu").distribute(one_rank)
    B = pt.from_array(y, (4, 4), device="cpu").distribute(one_rank)
    C = A @ B
    assert C.is_distributed and C.mesh_axes[1] == ("data", "model")
    np.testing.assert_allclose(C.collect().numpy(), x @ y, **TOL)
    G = pt.matmul_ta(A, A)
    assert G.is_distributed
    np.testing.assert_allclose(G.collect().numpy(), x.T @ x, **TOL)
    assert seen and all(t == ("Tensor", "Tensor") for t in seen), seen


LAZY_EXPRS = {
    "chain": lambda a, b: ((a + 1.0) * a).abs().sqrt(),
    "sum0": lambda a, b: (a * 2.0).sum(axis=0),
    "sum": lambda a, b: (a * a).sum(),
    "matmul": lambda a, b: a @ b,
    "matmul_ta": lambda a, b: a.T @ a,
    "power_body": lambda a, b: a.T @ (a @ b),
    "slice": lambda a, b: a[3:17] - 1.0,
}
# the eager op each plan runs, where the optimizer rewrote it: the
# transpose folded into ``matmul_ta``
EAGER = {"matmul_ta": lambda a, b: pt.matmul_ta(a, a),
         "power_body": lambda a, b: pt.matmul_ta(a, a @ b)}


@pytest.mark.parametrize("expr", list(LAZY_EXPRS))
def test_lazy_plan_over_a_distributed_array_equals_its_eager_result(one_rank, expr,
                                                                   monkeypatch):
    """A plan recorded over a distributed array runs its nodes as the eager
    ops run on the mesh: the same values, grid, pad state and placement,
    its recorded metadata that of the result, and no DTensor at a kernel."""
    from repro_torch.kernels.matmul import ops
    seen = []
    real = ops.local_matmul

    def spy(a, b, **kw):
        seen.append((type(a).__name__, type(b).__name__))
        return real(a, b, **kw)
    monkeypatch.setattr(ops, "local_matmul", spy)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(20, 12)).astype(np.float32)
    y = rng.normal(size=(12, 3)).astype(np.float32)
    A = pt.from_array(x, (8, 4), device="cpu").distribute(one_rank)
    B = pt.from_array(y, (4, 3), device="cpu")
    fn = LAZY_EXPRS[expr]
    want = EAGER.get(expr, fn)(A, B)
    lazy = fn(A.lazy(), B)
    got = lazy.compute()
    if isinstance(want, torch.Tensor):
        np.testing.assert_allclose(float(got), float(want), **TOL)
        return
    np.testing.assert_allclose(got.collect().numpy(), want.collect().numpy(), **TOL)
    assert got.is_distributed and want.is_distributed
    assert tuple(got.blocks.placements) == tuple(want.blocks.placements)
    assert (got.stacked_grid, got.pad_state) == (want.stacked_grid, want.pad_state)
    assert (lazy.stacked_grid, lazy.pad_state) == (got.stacked_grid, got.pad_state)
    assert placement.is_dtensor(lazy.expr.meta.blocks)
    assert all(t == ("Tensor", "Tensor") for t in seen), seen


def test_kmeans_on_a_distributed_array_single_rank(one_rank, monkeypatch):
    """``KMeans`` fit, predict and score of a distributed array equal the
    reference's on a one-device mesh (labels exactly); the assignment
    kernel's wrapper only ever sees plain tensors."""
    import jax
    from jax.sharding import Mesh
    import repro.core as jx
    from repro.algorithms.kmeans import KMeans as JKMeans
    from repro_torch.algorithms import kmeans as kmod
    seen = []
    real = kmod.kmeans_assign_stacked

    def spy(blocks, centers, n):
        seen.append(type(blocks).__name__)
        return real(blocks, centers, n)
    monkeypatch.setattr(kmod, "kmeans_assign_stacked", spy)
    x = np.random.default_rng(12).normal(size=(64, 48)).astype(np.float32)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ref = JKMeans(n_clusters=3, max_iter=3).fit(jx.from_array(x, (16, 16)).distribute(jmesh))
    a = pt.from_array(x, (16, 16), device="cpu").distribute(one_rank)
    km = pt.KMeans(n_clusters=3, max_iter=3).fit(a)
    np.testing.assert_allclose(km.centers_.numpy(), np.asarray(ref.centers_), **TOL)
    labels = km.predict(a)
    assert labels.is_distributed
    np.testing.assert_array_equal(labels.collect().numpy(),
                                  np.asarray(ref.predict(jx.from_array(x, (16, 16))).collect()))
    np.testing.assert_allclose(km.score(a), ref.score(jx.from_array(x, (16, 16))), rtol=1e-4)
    assert seen and set(seen) == {"Tensor"}, seen


def test_pca_and_ridge_on_a_distributed_array_single_rank(one_rank, monkeypatch):
    """``PCA`` and ``Ridge`` fit through lazy plans over a distributed array,
    and transform and predict it, as the reference does on one device."""
    import jax.numpy as jnp
    import repro.core as jx
    from repro.algorithms import linalg as jlin
    from repro.estimators.linear import Ridge as JRidge
    from repro_torch.algorithms import linalg as plin
    rng = np.random.default_rng(13)
    x = rng.normal(size=(64, 48)).astype(np.float32)
    y = rng.normal(size=(64,)).astype(np.float32)
    q0 = rng.normal(size=(48, 2)).astype(np.float32)
    monkeypatch.setattr(plin, "_initial_q",
                        lambda m, k, seed, device: torch.as_tensor(q0, device=device))
    monkeypatch.setattr(jlin.jax.random, "normal",
                        lambda key, shape, *a, **kw: jnp.asarray(q0))
    a = pt.from_array(x, (16, 16), device="cpu").distribute(one_rank)
    xj = jx.from_array(x, (16, 16))
    p, pj = plin.PCA(n_components=2).fit(a), jlin.PCA(n_components=2).fit(xj)
    np.testing.assert_allclose(p.components_.numpy(), np.asarray(pj.components_), **TOL)
    np.testing.assert_allclose(p.explained_variance_.numpy(),
                               np.asarray(pj.explained_variance_), rtol=1e-4)
    t = p.transform(a)
    assert t.is_distributed
    np.testing.assert_allclose(t.collect().numpy(), np.asarray(pj.transform(xj).collect()),
                               **TOL)
    r, rj = pt.Ridge(alpha=0.1).fit(a, y), JRidge(alpha=0.1).fit(xj, y)
    np.testing.assert_allclose(r.coef_, rj.coef_, **TOL)
    np.testing.assert_allclose(r.intercept_, rj.intercept_, **TOL)
    np.testing.assert_allclose(r.predict(a).collect().numpy(),
                               np.asarray(rj.predict(xj).collect()), **TOL)


def test_save_blocks_of_a_distributed_array_single_rank(one_rank, tmp_path):
    """The spill of a distributed array is the undistributed array's, byte
    for byte, and ``load_blocks`` reads it back equal."""
    from repro_torch.core import io
    x = np.random.default_rng(14).normal(size=(40, 24)).astype(np.float32)
    plain = pt.from_array(x, (16, 8), device="cpu")
    io.save_blocks(str(tmp_path / "placed"), plain.distribute(one_rank))
    io.save_blocks(str(tmp_path / "plain"), plain)
    names = sorted(os.listdir(tmp_path / "plain"))
    assert names == sorted(os.listdir(tmp_path / "placed")) and "meta.json" in names
    for name in names:
        assert (tmp_path / "placed" / name).read_bytes() == \
            (tmp_path / "plain" / name).read_bytes(), name
    back = io.load_blocks(str(tmp_path / "placed"), device="cpu")
    np.testing.assert_array_equal(back.collect().numpy(), x)


def test_checkpoint_save_of_a_dtensor_leaf_single_rank(one_rank, tmp_path):
    """``checkpoint.save`` of a DTensor leaf writes the undistributed leaf's
    files, and ``restore`` gives it back as a plain tensor."""
    from repro_torch.checkpoint import checkpoint as ck
    x = np.random.default_rng(15).normal(size=(40, 24)).astype(np.float32)
    plain = pt.from_array(x, (16, 8), device="cpu")
    ck.save(str(tmp_path / "placed"), 3, {"w": plain.distribute(one_rank).blocks,
                                          "n": np.int32(7)})
    ck.save(str(tmp_path / "plain"), 3, {"w": plain.blocks, "n": np.int32(7)})
    for name in sorted(os.listdir(tmp_path / "plain" / "step_00000003")):
        assert (tmp_path / "placed" / "step_00000003" / name).read_bytes() == \
            (tmp_path / "plain" / "step_00000003" / name).read_bytes(), name
    back = ck.restore(str(tmp_path / "placed"), 3,
                      {"w": torch.zeros(plain.blocks.shape), "n": np.int32(0)},
                      device="cpu")
    assert not placement.is_dtensor(back["w"])
    assert torch.equal(back["w"], plain.blocks)
