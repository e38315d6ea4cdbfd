"""Named + versioned model registry for the predict server (the port of
``repro.serve.registry``).

``fit`` happens somewhere with time to spare; ``serve`` happens millions of
times with a latency budget.  The registry is the seam between them: it
loads fitted estimators from ``BaseEstimator.save_model`` manifests (the
``repro-model-v1`` format either package writes; versions are checkpoint
steps), pins their fitted tensors on its device, declares the geometry
buckets each model serves, and warms every (model, bucket) predict plan
through :mod:`repro_torch.serve.compilecache` so that no request pays
load-time work.

``ModelRegistry(device=...)`` names the device once (default ``"cuda"``;
the tests pass ``"cpu"``): every bucket, every ``load_model`` and every
direct predict builds there.  ``register`` serves an already-fitted
in-process estimator; ``load`` goes through the model files.  Both return
the :class:`ServedModel` handle the server dispatches on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import checkpoint as _ckpt
from repro_torch.core import sparse as _sparse
from repro_torch.core.dsarray import from_array, resolve_device
from repro_torch.estimators.base import _host
from repro_torch.serve.batching import (BucketSpec, FORMAT_DENSE,
                                        normalize_payload)
from repro_torch.serve.compilecache import PredictCompileCache


def _infer_n_features(est) -> Optional[int]:
    """Feature count from the fitted state, for specs that omit it."""
    n = getattr(est, "n_features_in_", 0)
    if n:
        return int(n)
    coef = getattr(est, "coef_", None)
    if coef is not None:
        return int(_host(coef).shape[0])
    edges = getattr(est, "edges_", None)          # forest: (m, bins-1)
    if edges is not None:
        return int(_host(edges).shape[0])
    sv = getattr(est, "sv_", None)                # csvm: (k, m)
    if sv is not None:
        return int(_host(sv).shape[1])
    return None


def _pin_device(est, device: torch.device) -> None:
    """Move the fitted tensor state to ``device`` and wait for it, so the
    first request never overlaps a host-to-device copy.  Host NumPy
    leaves stay on the host, as the reference leaves its host state."""
    for k, v in est._fitted_state().items():
        if isinstance(v, torch.Tensor) and v.device != device:
            setattr(est, k, v.to(device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ServedModel:
    """One (name, version) entry: estimator + geometry spec + warm cache."""

    name: str
    version: int
    estimator: object
    spec: BucketSpec
    cache: PredictCompileCache

    @property
    def plan_backed(self) -> bool:
        return self.cache.plan_backed

    def normalize(self, payload) -> Tuple[object, int, str]:
        return normalize_payload(payload, self.spec.n_features)

    def predict_direct(self, payload) -> np.ndarray:
        """Unbatched predict of ONE request payload at natural geometry —
        the shed-batching fallback and the out-of-bucket path.  Builds on
        the registry's device and collects to a host ``(r, 1)`` array,
        exactly what ``estimator.predict`` on the same rows returns."""
        payload, n, fmt = self.normalize(payload)
        shape = (min(n, 128) or 1, self.spec.n_features)
        if fmt == FORMAT_DENSE:
            # the blocking a raw array gets from ``_validate_x``
            x = from_array(payload, shape, device=self.spec.device)
        else:
            x = _sparse.from_scipy(payload, shape, device=self.spec.device)
        return _host(self.estimator.predict(x))


class ModelRegistry:
    """Name -> version -> :class:`ServedModel`, with AOT warm on entry."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._models: Dict[str, Dict[int, ServedModel]] = {}

    # -- registration --------------------------------------------------------
    def register(self, name: str, estimator, *,
                 version: int = 0,
                 batch_sizes: Sequence[int] = (1, 8, 32),
                 formats: Sequence[str] = (FORMAT_DENSE,),
                 n_features: Optional[int] = None,
                 block_rows: Optional[int] = None,
                 dtype: str = "float32",
                 nse: Optional[int] = None,
                 warm: bool = True) -> ServedModel:
        """Serve a fitted estimator under ``name``/``version``.

        Declares the geometry buckets (``batch_sizes`` x ``formats``; bcoo
        needs ``nse``), pins fitted tensors on the registry's device, and
        (by default) warms the per-bucket predict plans right here — model
        load is where first-use cost belongs, not the first request.
        """
        if n_features is None:
            n_features = _infer_n_features(estimator)
        if n_features is None:
            raise ValueError(
                f"cannot infer n_features for {type(estimator).__name__}; "
                "pass n_features= explicitly")
        spec = BucketSpec(n_features, batch_sizes=batch_sizes,
                          formats=formats, block_rows=block_rows,
                          dtype=dtype, nse=nse, device=str(self.device))
        _pin_device(estimator, self.device)
        model = ServedModel(name=name, version=int(version),
                            estimator=estimator, spec=spec,
                            cache=PredictCompileCache(estimator, spec))
        if warm:
            model.cache.warm()
        self._models.setdefault(name, {})[int(version)] = model
        return model

    def load(self, name: str, directory: str, *,
             version: Optional[int] = None, **spec_kw) -> ServedModel:
        """Load a ``save_model`` checkpoint and serve it.  ``version=None``
        serves the newest committed version in the directory; the registry
        entry keeps the on-disk version number either way."""
        from repro_torch.estimators import load_model
        if version is None:
            steps = _ckpt.list_steps(directory)
            if not steps:
                raise FileNotFoundError(f"no model checkpoint in {directory!r}")
            version = steps[-1]
        est = load_model(directory, version=version, device=self.device)
        return self.register(name, est, version=version, **spec_kw)

    # -- lookup --------------------------------------------------------------
    def get(self, name: str, version: Optional[int] = None) -> ServedModel:
        """The served model for ``name`` (newest version by default)."""
        versions = self._models.get(name)
        if not versions:
            raise KeyError(f"no model registered under {name!r}")
        if version is None:
            return versions[max(versions)]
        if version not in versions:
            raise KeyError(
                f"model {name!r} has versions {sorted(versions)}, "
                f"not {version}")
        return versions[version]

    def versions(self, name: str) -> List[int]:
        return sorted(self._models.get(name, {}))

    def models(self) -> List[Tuple[str, int]]:
        """Every (name, version) pair currently registered."""
        return [(n, v) for n, vs in sorted(self._models.items())
                for v in sorted(vs)]

    def warm_all(self) -> int:
        """(Re-)warm every registered model; returns the runs built."""
        return sum(m.cache.warm() for _, vs in self._models.items()
                   for m in vs.values())

    def warmed_plans(self) -> List:
        """Distinct warmed predict plans across the registry (what the
        profiler and the analysis layer inspect)."""
        seen, out = set(), []
        for _, vs in sorted(self._models.items()):
            for v in sorted(vs):
                for p in vs[v].cache.warmed_plans():
                    if p.key not in seen:
                        seen.add(p.key)
                        out.append(p)
        return out
