"""Per-(model, geometry) warm-up of predict plans (the port of
``repro.serve.compilecache``).

At model-LOAD time the cache records the estimator's predict plan on a
representative zero input for every declared geometry bucket and pushes it
through ``Plan.compile_aot()``: the run callable goes into the shared
structural plan cache and, on the card, runs once, so that the kernels are
built and loaded and the allocator has grown before any request.  The
FIRST real request of a warmed geometry then replays an existing run.

Steady-state contract (asserted by ``tests/test_torch_serve.py`` and
``chip_smoke.py`` phase 12): across a request stream of warmed
geometries, ``plan.cache_stats()`` shows ``opt_runs`` frozen after warm-up
(every request's re-recording hits ``_OPT_CACHE``), zero new cache misses,
and ``serve.stats()["cache_hits"] == requests``.

Estimators that cannot record predict as a plan (``has_predict_plan()``
False — K-means, the forest's vote, the CSVM's decision) still get
geometry bucketing: ``warm`` runs one eager predict per bucket (on the card
that is where their kernels are built and loaded), and dispatch routes
through eager ``predict`` at bucket geometry, with no plan-level cache
accounting.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core import plan as _plan
from repro_torch.core.dsarray import DsArray
from repro_torch.serve import stats as _stats
from repro_torch.serve.batching import (BucketSpec, GeometryBucket,
                                        representative_input)


class PredictCompileCache:
    """AOT-warmed predict plans for ONE estimator across its bucket set.

    ``donate_inputs`` marks the request-batch leaf of each warmed plan as
    donatable (``Plan.compile_aot(donate_argnums=...)``): the packed batch
    is a per-request temporary the dispatcher never reuses.
    Model-parameter leaves are never donated — they are the fitted state
    every later request re-binds.  Torch has no donation: the positions
    are checked and kept on the plan, and nothing is aliased.
    """

    def __init__(self, estimator, spec: BucketSpec,
                 donate_inputs: bool = True):
        self.estimator = estimator
        self.spec = spec
        self.donate_inputs = donate_inputs
        self.plan_backed = estimator.has_predict_plan()
        #: bucket -> structural key of the warmed plan (the cache-hit oracle)
        self.warmed_keys: Dict[GeometryBucket, tuple] = {}
        #: bucket -> the warmed Plan (kept for analysis linting / tests)
        self.plans: Dict[GeometryBucket, _plan.Plan] = {}

    def _donate_argnums(self, p: _plan.Plan, x: DsArray) -> tuple:
        """Leaf positions holding the representative batch ``x`` — the only
        buffers a warmed predict executable may consume."""
        if not self.donate_inputs:
            return ()
        return tuple(i for i, leaf in enumerate(p.leaves)
                     if getattr(leaf, "value", None) is x)

    def warm(self) -> int:
        """Record + warm the predict plan for every declared bucket
        (idempotent).  Returns the number of runs built — a steady-state
        re-warm returns 0."""
        compiled = 0
        for bucket in self.spec.buckets():
            x = representative_input(bucket)
            if not self.plan_backed:
                # no recordable plan: one eager predict builds and loads
                # the kernels of the estimator's own predict path
                if bucket not in self.warmed_keys:
                    self.estimator.predict(x)
                    self.warmed_keys[bucket] = ()
                continue
            p = self.estimator.predict_plan(x)
            if p.compile_aot(donate_argnums=self._donate_argnums(p, x)):
                compiled += 1
            self.warmed_keys[bucket] = p.key
            self.plans[bucket] = p
        return compiled

    def plan_for(self, x: DsArray,
                 bucket: GeometryBucket) -> Tuple[Optional[_plan.Plan], bool]:
        """The predict plan for a bucket-shaped batch ``x`` -> ``(plan,
        warmed)``.  ``warmed`` is True when the plan's structural key
        matches the bucket's warmed entry — the per-request cache-hit
        counter the acceptance asserts equals the request count."""
        if not self.plan_backed:
            return None, False
        p = self.estimator.predict_plan(x)
        return p, p.key == self.warmed_keys.get(bucket)

    def warmed_plans(self) -> List[_plan.Plan]:
        """The distinct warmed plans (for analysis and the profiler)."""
        seen, out = set(), []
        for p in self.plans.values():
            if p.key not in seen:
                seen.add(p.key)
                out.append(p)
        return out


def record_cache_outcome(warmed: bool, n_requests: int) -> None:
    """Account one batched plan dispatch against the serve counters."""
    _stats.bump("cache_hits" if warmed else "cache_misses", n_requests)
