"""The port stands alone: it imports neither jax nor the JAX package, and it
never lands on the CPU unless the caller names the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as pt  # noqa: E402
import repro_torch.configs  # noqa: E402
import repro_torch.data  # noqa: E402
import repro_torch.launch.train  # noqa: E402
import repro_torch.models.model  # noqa: E402
import repro_torch.optim  # noqa: E402
import repro_torch.serve  # noqa: E402
import repro_torch.train  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[ .])")

_SCRIPT = """
import sys
import numpy as np
import repro_torch as pt
import repro_torch.models
import repro_torch.launch.serve
import repro_torch.kernels.flash_attention.ops
import repro_torch.kernels.ssd.ops
import repro_torch.core.expr
import repro_torch.core.plan
import repro_torch.core.shuffle
import repro_torch.core.sparse
import repro_torch.core.costmodel
import scipy.sparse
import torch
from repro_torch.algorithms import KMeans
x = pt.from_array(np.random.default_rng(0).normal(size=(40, 3)), (16, 2),
                  device="cpu")
km = KMeans(n_clusters=2, max_iter=5).fit(x)
km.predict(x)
km.score(x)
(x @ x.T).sum()
with pt.lazy():
    y = ((x + 1.0) * 2.0).abs().sqrt()
    s = pt.pseudo_shuffle(torch.Generator().manual_seed(0), y)
    c = pt.concat_rows([s, x[3:10]])
pt.compute_multi(y.T @ x, c.norm(axis=1), y.sum(axis=0), y.mean())
r = pt.from_scipy(scipy.sparse.random(40, 3, density=0.5, random_state=0),
                  (16, 2), device="cpu")
KMeans(n_clusters=2, max_iter=5).fit(r).score(r)
pt.compute_multi((r.lazy() * r).sum(axis=1), r.lazy().T @ x,
                 (r * 2.0 + r).lazy().todense())
repro_torch.core.sparse.canonicalize(r + r)
import repro_torch.estimators
import repro_torch.algorithms.linalg
import repro_torch.algorithms.als
import repro_torch.core.dataset_baseline
from repro_torch.algorithms import ALS, PCA
from repro_torch.estimators import CascadeSVM, RandomForestClassifier, Ridge
rng = np.random.default_rng(1)
xs = rng.normal(size=(48, 4)).astype(np.float32)
xd = pt.from_array(xs, (16, 4), device="cpu")
labels = (xs[:, 0] > 0).astype(np.int32)
PCA(n_components=2, n_iter=5).fit(xd).transform(xd)
Ridge(alpha=0.5).fit(xd, xs[:, 1]).predict(xd)
ALS(n_factors=2, max_iter=2).fit(pt.from_array(np.abs(xs) @ np.abs(xs).T,
                                               (16, 16), device="cpu"))
CascadeSVM(sv_cap=8, max_iter=2, solver_iters=20).fit(xd, labels).predict(xd)
RandomForestClassifier(n_estimators=2, max_depth=3).fit(xd, labels).predict(xd)
repro_torch.launch.serve.main(["--smoke", "--device", "cpu", "--batch", "1",
                               "--prompt-len", "3", "--gen", "2"])
import os, tempfile
import repro_torch.checkpoint
import repro_torch.core.io
import repro_torch.core.readers
import repro_torch.resilience
import repro_torch.resilience.execute
import repro_torch.resilience.guards
import repro_torch.resilience.inject
from repro_torch.estimators import load_model
d = tempfile.mkdtemp()
km.save_model(os.path.join(d, "m"))
load_model(os.path.join(d, "m"), device="cpu").predict(x)
KMeans(n_clusters=2, max_iter=3).fit(x, checkpoint_dir=os.path.join(d, "c"),
                                     resume=os.path.join(d, "c"))
np.save(os.path.join(d, "x.npy"), xs)
repro_torch.core.io.load_npy_rows(os.path.join(d, "x.npy"), (16, 4),
                                  device="cpu")
np.savetxt(os.path.join(d, "x.txt"), xs, delimiter=",")
repro_torch.core.io.load_txt_file(os.path.join(d, "x.txt"), (16, 4),
                                  device="cpu")
R = repro_torch.resilience
with R.inject(R.FaultSpec(kind="oom", site="plan_execute",
                          modes=("fused", "eager"), times=None)):
    R.run_resilient(xd.lazy() @ xd.T, guard="finite")
xd.finite_report()
import repro_torch.serve
import repro_torch.obs.profiler
import repro_torch.analysis
from repro_torch import obs
ridge = Ridge(alpha=0.5).fit(xd, xs[:, 1])
reg = repro_torch.serve.ModelRegistry(device="cpu")
reg.register("ridge", ridge, batch_sizes=(1, 4), block_rows=4)
reg.register("km", km, n_features=3, batch_sizes=(4,))
srv = repro_torch.serve.PredictServer(reg)
futs = [srv.submit("ridge", xs[:3]), srv.submit("km", np.ones((2, 3)))]
srv.pump()
[f.result() for f in futs]
obs.profile(ridge.predict_plan(xd))
repro_torch.analysis.liveness.analyze(ridge.predict_plan(xd).roots)
import repro_torch.analysis.__main__
import repro_torch.analysis.graphs
repro_torch.analysis.check([(xd.lazy() * 2.0 + 1.0).sum(), r.lazy().T @ x])
assert repro_torch.analysis.__main__.main(
    ["--device", "cpu", "--scenario", "six-op-chain"]) == 0
import repro_torch.optim
import repro_torch.data
import repro_torch.train
import repro_torch.distributed
import repro_torch.distributed.sharding
import repro_torch.distributed.compression
import repro_torch.launch.train
import repro_torch.convert
import torch.distributed as dist
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), 1),
                        rank=0, world_size=1)
from repro_torch.core.compat import make_mesh
mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
tree = {"embed": torch.ones(8, 4), "lm_head": torch.ones(4, 8)}
placed = repro_torch.distributed.distribute(
    tree, repro_torch.distributed.param_shardings(tree, mesh))
repro_torch.optim.global_norm(placed)
repro_torch.distributed.compressed_psum(torch.ones(4, 5), mesh, "data",
                                        torch.Generator().manual_seed(0))
dist.destroy_process_group()
st = repro_torch.launch.train.main(
    ["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu", "--steps", "2",
     "--batch", "2", "--seq", "16", "--ckpt-dir", os.path.join(d, "t"),
     "--optimizer", "adafactor"])
repro_torch.data.pipeline_for_model(
    repro_torch.configs.get_smoke_config("zamba2-2.7b"), 2, 8,
    device="cpu").batch_at(0).as_dsarray()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(loaded)
sys.exit(1 if loaded else 0)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_DRYRUN = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import torch
import repro_torch.launch.mesh as mesh
import repro_torch.launch.specs as specs
import repro_torch.launch.costs as costs
import repro_torch.launch.dryrun as dryrun
from repro_torch.configs import get_smoke_config
from repro_torch.models.config import ShapeCell
cfg = get_smoke_config("zamba2-2.7b")
cell = ShapeCell("t", 32, 4, "train")
opt = dryrun.pick_optimizer(cfg, cfg.param_count())[0]
assert dryrun.estimate(cfg, cell, opt, 1, None)["memory"]["peak_bytes"] > 0
with mesh.fake_process_group(4):
    m = mesh.make_host_mesh((2, 2), ("data", "model"))
    r = dryrun.estimate(cfg, cell, opt, 2, m, mode="tp_sp")
    assert r["hlo"]["collective_bytes"] > 0
specs.input_specs(get_smoke_config("mamba2-370m"), "long_500k")
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_dryrun_imports_no_jax_and_no_reference():
    """The dry run's four modules import, and run a SMOKE step with and
    without a fake mesh, with jax and the JAX package blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _DRYRUN], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_sources_have_no_jax_or_reference_imports():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if FORBIDDEN.match(line)]
    assert not bad, bad


def test_default_device_is_cuda_and_never_falls_back():
    """Without ``device=`` the creation routines, and an estimator's fit of
    a raw array, ask for the card; where there is none they raise instead
    of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    arr = np.ones((4, 4), np.float32)
    for make in (lambda: pt.from_array(arr, (2, 2)),
                 lambda: pt.zeros((4, 4), (2, 2)),
                 lambda: pt.full((4, 4), (2, 2), 1.0),
                 lambda: pt.eye(4, (2, 2)),
                 lambda: pt.Ridge().fit(arr, np.ones(4)),
                 lambda: pt.PCA().fit(arr),
                 lambda: pt.KMeans(n_clusters=2).fit(arr),
                 lambda: pt.RandomForestClassifier().fit(arr, [0, 1, 0, 1]),
                 lambda: pt.CascadeSVM().fit(arr, [0, 1, 0, 1]),
                 lambda: repro_torch.serve.ModelRegistry(),
                 lambda: repro_torch.serve.batching.representative_input(
                     repro_torch.serve.BucketSpec(4).buckets()[0]),
                 lambda: repro_torch.data.SyntheticPipeline(
                     repro_torch.data.PipelineConfig()),
                 lambda: repro_torch.train.init_state(
                     repro_torch.models.model.build_model(
                         repro_torch.configs.get_smoke_config("zamba2-2.7b")),
                     repro_torch.optim.make_optimizer("adamw"),
                     torch.Generator()),
                 lambda: repro_torch.launch.train.main(
                     ["--arch", "zamba2-2.7b", "--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
