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
                 lambda: pt.CascadeSVM().fit(arr, [0, 1, 0, 1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
