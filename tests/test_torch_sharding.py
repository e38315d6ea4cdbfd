"""The port's sharding rules (``repro_torch.distributed.sharding``) against the
reference's (``repro.distributed.sharding``), spec by spec.

The reference runs once, in one subprocess with four forced jax CPU devices
(a 2 x 2 ``("data", "model")`` mesh, as ``tests/test_distributed.py`` runs
it), over ``jax.eval_shape`` trees of every SMOKE config: the parameter
specs unsanitized and sanitized for the mesh, the decode caches' specs,
the batch specs, AdamW's and Adafactor's state shardings, and
``sanitize_spec`` on uneven shapes.  The port computes the same in this
process over ``meta`` trees with a stand-in for a 2 x 2 ``DeviceMesh``
(the rules read only the mesh's axis names and sizes).  Every spec is
compared as a list of axis-name entries (``None``, a name, or a list of
names), path by path.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import all_arch_ids, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import Batch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(all_arch_ids())
BATCH = dict(tokens=(8, 16), labels=(8, 16), patches=(8, 4, 6))
CACHE = (2, 16)                        # batch, max_len
SANITIZE = [                           # spec, shape, mesh ("22" or "model1")
    (["model", None], [7, 3], "model1"),
    (["data", "model"], [3, 4], "22"),
    (["data", "model"], [4, 6], "22"),
    ([["data", "model"], None], [6, 2], "22"),
    ([["data", "model"]], [8], "22"),
    (["data", None, "model"], [4], "22"),
    ([None, "model", "data"], [5, 2, 2], "22"),
]

_REF = r"""
import json, sys
import jax, numpy as np
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.configs import get_smoke_config
from repro.core.compat import make_mesh
from repro.data.pipeline import Batch
from repro.distributed import sharding as sh
from repro.models.model import build_model
from repro.optim import make_optimizer

ARCHS, BATCH, CACHE, SANITIZE = json.loads(sys.argv[1])
mesh = make_mesh((2, 2), ("data", "model"))
mesh1 = make_mesh((1,), ("model",), devices=jax.devices()[:1])

def entry(e):
    return list(e) if isinstance(e, tuple) else e

def spec(s):
    if isinstance(s, NamedSharding):
        s = s.spec
    return [entry(e) for e in s]

def by_path(tree, specs):
    paths, _, _ = sh.tree_paths(tree)
    leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, (P, NamedSharding)))
    return dict(zip(paths, [spec(s) for s in leaves]))

out = {"archs": {}}
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: model.init_cache(*CACHE))
    rec = {"param_specs": by_path(params, sh.param_specs(params)),
           "param_specs_22": by_path(params, sh.param_specs(params, mesh)),
           "cache_specs_22": by_path(cache, sh.cache_specs(cache, mesh, ("data",)))}
    for kind in ("adamw", "adafactor"):
        st = jax.eval_shape(make_optimizer(kind).init, params)
        rec[f"opt_{kind}_22"] = by_path(st, sh.opt_state_shardings(st, params, mesh))
    out["archs"][arch] = rec
batch = Batch(**{k: jax.ShapeDtypeStruct(tuple(v), np.int32) for k, v in BATCH.items()})
bs = sh.batch_specs(batch, mesh, ("data",))
out["batch_22"] = {k: spec(getattr(bs, k)) for k in BATCH}
bs = sh.batch_specs(batch, mesh, ("data", "model"))
out["batch_22_fsdp"] = {k: spec(getattr(bs, k)) for k in BATCH}
out["sanitize"] = [spec(sh.sanitize_spec(P(*[tuple(e) if isinstance(e, list) else e
                                               for e in s]), tuple(shape),
                                         mesh if m == "22" else mesh1))
                   for s, shape, m in SANITIZE]
print("JSON" + json.dumps(out))
"""


class _Mesh:
    """A stand-in for a ``DeviceMesh``: its axis names and sizes."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names, self.ndim = tuple(shape), tuple(names), len(shape)

    def size(self, i=None):
        return self.shape[i]


MESH22 = _Mesh((2, 2), ("data", "model"))
MESH1 = _Mesh((1,), ("model",))


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF),
                           json.dumps([ARCHS, BATCH, CACHE, SANITIZE])],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _by_path(tree, specs):
    paths, _, _ = sh.tree_paths(tree)
    got_paths, leaves, _ = sh.spec_tree_paths(specs)
    assert got_paths == paths
    leaves = [s.spec if isinstance(s, sh.Sharding) else s for s in leaves]
    return dict(zip(paths, [[_entry(e) for e in s] for s in leaves]))


def _port(arch):
    model = build_model(get_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(0), "meta")
    kw = {"enc_len": CACHE[1]} if model.cfg.family == "encdec" else {}
    cache = model.init_cache(*CACHE, device="meta", **kw)
    return model, params, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(ref, arch):
    """Every leaf's spec, by the name rules alone and sanitized for a 2 x 2
    mesh (a dim the axis extent does not divide replicates)."""
    _, params, _ = _port(arch)
    want = ref["archs"][arch]
    got = _by_path(params, sh.param_specs(params))
    assert got == want["param_specs"]
    assert any(any(e is not None for e in s) for s in got.values())
    assert _by_path(params, sh.param_specs(params, MESH22)) == want["param_specs_22"]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_optimizer_specs_match_reference(ref, arch):
    """The decode cache's specs and the AdamW / Adafactor states' shardings
    (inherited from the parameter of the same shape) on a 2 x 2 mesh."""
    model, params, cache = _port(arch)
    want = ref["archs"][arch]
    got = _by_path(cache, sh.cache_specs(cache, MESH22, ("data",)))
    # the port's cache position is a Python int (the reference's an int32
    # scalar): both replicate
    assert got == want["cache_specs_22"]
    for kind in ("adamw", "adafactor"):
        st = make_optimizer(kind).init(params)
        got = _by_path(st, sh.opt_state_shardings(st, params, MESH22))
        assert got == want[f"opt_{kind}_22"], kind


def test_batch_specs_match_reference(ref):
    """Each batch leaf's leading dim over the dp axes (both ``("data",)`` and
    the fsdp mode's whole mesh); a ``Batch`` of specs for a ``Batch``."""
    batch = Batch(**{k: torch.empty(v, dtype=torch.int32, device="meta")
                     for k, v in BATCH.items()})
    for dp, key in ((("data",), "batch_22"), (("data", "model"), "batch_22_fsdp")):
        bs = sh.batch_specs(batch, MESH22, dp)
        assert isinstance(bs, Batch)
        assert {k: [_entry(e) for e in getattr(bs, k)] for k in BATCH} == ref[key]
    assert sh.batch_specs(Batch(batch.tokens, batch.labels), MESH22, ("data",)).patches is None


def test_sanitize_spec_matches_reference(ref):
    """The reference's ``test_sharding_rules_sanitize`` (a 1-device mesh
    keeps every entry) and uneven cases on 2 x 2: a dim the extent does not
    divide, a dim over both axes, a spec longer than the shape."""
    got = [[_entry(e) for e in sh.sanitize_spec(
        sh.Spec(*[tuple(e) if isinstance(e, list) else e for e in s]), tuple(shape),
        MESH22 if m == "22" else MESH1)] for s, shape, m in SANITIZE]
    assert got == ref["sanitize"]
    assert got[0] == ["model", None]


def test_spec_placements_and_shardings():
    """A spec's DTensor placements (one per mesh dim, in mesh order), and
    ``param_shardings`` as ``Sharding(mesh, sanitized spec)`` leaves."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.core.placement import spec_placements
    assert spec_placements(MESH22, sh.Spec("model", "data")) == (Shard(1), Shard(0))
    assert spec_placements(MESH22, sh.Spec(("data", "model"), None)) == (Shard(0), Shard(0))
    assert spec_placements(MESH22, sh.Spec(None, None)) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        spec_placements(MESH22, sh.Spec("data", "data"))
    with pytest.raises(ValueError):
        spec_placements(MESH22, sh.Spec("pod"))
    _, params, _ = _port("yi-9b")
    shardings = sh.param_shardings(params, MESH22)
    assert shardings["embed"] == sh.Sharding(MESH22, sh.Spec("model", "data"))
    assert shardings["groups"][0]["attn"]["wk"].spec == sh.Spec(None, "data", "model")
