"""``python -m repro_torch.analysis`` — lint the plans behind the examples
and estimator fits (the port of ``repro.analysis.__main__``).

Re-records the lazy plans the example scripts and estimator ``fit`` loops
actually build (fits are captured live via ``plan.capture_plans``), runs
every registered rule over each distinct plan, prints the findings plus the
``peak-hbm-liveness`` naive-vs-minimized numbers, and exits nonzero on any
unsuppressed finding at or above ``--fail-on`` (default: warn — zero
unexplained findings).

Every array is built on ``--device`` (default ``cuda``; ``--device cpu``
runs the plain versions of the kernels), from NumPy seeds.

Waivers live in :data:`WAIVERS`: one suppression token (``rule@site``,
never a whole rule id) per entry, each a finding of the port recorded as a
deviation from the reference in ``ROADMAP.md`` §3, with its one-line reason.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Iterator, List, Tuple

import numpy as np

from repro_torch import analysis
from repro_torch.core import from_array, plan as _plan
from repro_torch.core.io import from_array_auto

#: token -> one-line justification.  Each entry is a finding the reference
#: does not make, recorded as a deviation in ROADMAP.md §3.
WAIVERS: Dict[str, str] = {
    "no-full-grid-intermediate@entry:fused-step-outputs":
        "every write beyond the budget is the output of one step of a fused "
        "Blockwise, a composed function of eager torch ops (ROADMAP.md §3, "
        "'Fused chains write their intermediates'; one launch per chain is "
        "§2's queued kernel)",
}


def dedup(plans: List["_plan.Plan"]) -> List["_plan.Plan"]:
    """Distinct plans by structural key (hot loops re-plan one structure)."""
    seen, out = set(), []
    for p in plans:
        if p.key not in seen:
            seen.add(p.key)
            out.append(p)
    return out


def _captured(fit) -> List["_plan.Plan"]:
    with _plan.capture_plans() as caught:
        fit()
    return dedup(caught)


# -- scenario builders -------------------------------------------------------


def _six_op_chain(device) -> List["_plan.Plan"]:
    """The fusion acceptance chain: 6 elementwise ops fusing to one body."""
    xa = np.random.default_rng(0).standard_normal((64, 48), np.float32)
    a = from_array(xa, (8, 8), device=device).lazy()
    r = (((a + a) * 2.0 - a).abs() * 0.5 + 0.25)
    return [_plan.plan_for(r)]


def _quickstart(device) -> List["_plan.Plan"]:
    """The lazy mirrors of examples/quickstart.py: the paper's indexing
    expression, gram matmul, and the Fig. 5 column mean."""
    xa = np.random.default_rng(1).random((200, 80), np.float32)
    x = from_array(xa, (50, 20), device=device).lazy()
    w = x[100:180, :40]
    paper_expr = (w.transpose().norm(axis=1) ** 2).sqrt()
    gram = x.transpose() @ x
    col_mean = x.mean(axis=0)
    return [_plan.plan_for(paper_expr),
            _plan.plan_for(gram, col_mean)]


def _linreg_fit(device) -> List["_plan.Plan"]:
    from repro_torch.estimators import LinearRegression
    rng = np.random.default_rng(2)
    x = from_array(rng.normal(size=(64, 6)).astype(np.float32), (16, 3),
                   device=device)
    y = rng.normal(size=(64,)).astype(np.float32)
    return _captured(lambda: LinearRegression().fit(x, y))


def _csvm_fit(device) -> List["_plan.Plan"]:
    from repro_torch.estimators import CascadeSVM
    rng = np.random.default_rng(3)
    xa = rng.normal(size=(64, 8)).astype(np.float32)
    y = (xa[:, 0] > 0).astype(np.float32)
    x = from_array(xa, (16, 8), device=device)
    return _captured(lambda: CascadeSVM(max_iter=1, solver_iters=20,
                                        sv_cap=16).fit(x, y))


def _csvm_sparse_fit(device) -> List["_plan.Plan"]:
    from repro_torch.estimators import CascadeSVM
    rng = np.random.default_rng(4)
    xa = rng.normal(size=(64, 8)).astype(np.float32)
    xa[rng.random(xa.shape) > 0.2] = 0.0
    y = (xa.sum(axis=1) > 0).astype(np.float32)
    x = from_array_auto(xa, (16, 8), "bcoo", device=device)
    return _captured(lambda: CascadeSVM(max_iter=1, solver_iters=20,
                                        sv_cap=16).fit(x, y))


def _kmeans_fit(device) -> List["_plan.Plan"]:
    from repro_torch.algorithms.kmeans import KMeans
    rng = np.random.default_rng(5)
    x = from_array(rng.normal(size=(64, 4)).astype(np.float32), (16, 4),
                   device=device)
    return _captured(lambda: KMeans(n_clusters=3, max_iter=2,
                                    seed=0).fit(x))


def _pca_fit(device) -> List["_plan.Plan"]:
    from repro_torch.algorithms.linalg import PCA
    rng = np.random.default_rng(6)
    x = from_array(rng.normal(size=(64, 8)).astype(np.float32), (16, 4),
                   device=device)
    return _captured(lambda: PCA(n_components=2, n_iter=3, seed=0).fit(x))


def _serve_predict(device) -> List["_plan.Plan"]:
    """The predict plans the serving registry warms: a fitted Ridge served
    dense and stacked-COO across its declared geometry buckets."""
    from repro_torch.estimators import Ridge
    from repro_torch.serve import ModelRegistry
    rng = np.random.default_rng(7)
    xa = rng.normal(size=(64, 8)).astype(np.float32)
    y = (xa @ rng.normal(size=(8, 1))).astype(np.float32)
    est = Ridge(alpha=0.1).fit(from_array(xa, (16, 8), device=device),
                               from_array(y, (16, 1), device=device))
    reg = ModelRegistry(device=device)
    try:
        import scipy.sparse  # noqa: F401
        formats, nse = ("dense", "bcoo"), 64
    except ImportError:                                # pragma: no cover
        formats, nse = ("dense",), None
    reg.register("ridge", est, batch_sizes=(8, 32), formats=formats,
                 block_rows=4, nse=nse)
    return dedup(reg.warmed_plans())


def _ingest_fit(device) -> List["_plan.Plan"]:
    """A fit on a STREAMED array: write an svmlight file, load it through
    the block-row-streaming loader (sparse x straight into a stacked COO,
    the way the paper's CSVM datasets arrive), and lint the plans behind a
    CascadeSVM fit on it."""
    import os
    import tempfile
    from repro_torch.core.io import load_svmlight_file
    from repro_torch.estimators import CascadeSVM
    rng = np.random.default_rng(8)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "train.svm")
        with open(path, "w") as f:
            for i in range(64):
                feats = rng.choice(8, size=3, replace=False) + 1
                vals = rng.normal(size=3)
                f.write(f"{float(i % 2)} " + " ".join(
                    f"{c}:{v:.5f}" for c, v in sorted(zip(feats, vals)))
                    + "\n")
        x, y = load_svmlight_file(path, (16, 8), n_features=8,
                                  chunk_bytes=256, device=device)
    yv = y.collect().cpu().numpy().ravel()
    return _captured(lambda: CascadeSVM(max_iter=1, solver_iters=20,
                                        sv_cap=16).fit(x, yv))


def _traced_fit(device) -> List["_plan.Plan"]:
    """A KMeans fit recorded UNDER TRACING: instrumentation changes no plan
    structure, and the trace round-trips as Chrome trace-event JSON with
    spans in it."""
    import json
    import os
    import tempfile
    from repro_torch import obs
    from repro_torch.algorithms.kmeans import KMeans
    rng = np.random.default_rng(9)
    x = from_array(rng.normal(size=(64, 4)).astype(np.float32), (16, 4),
                   device=device)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        with obs.trace_to(path):
            plans = _captured(lambda: KMeans(n_clusters=3, max_iter=2,
                                             seed=0).fit(x))
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"]
    assert events, "tracing a KMeans fit produced no spans"
    assert all(e.get("ph") == "X" and "ts" in e and "dur" in e
               for e in events), "malformed trace events"
    return plans


SCENARIOS = [
    ("six-op-chain", _six_op_chain),
    ("quickstart", _quickstart),
    ("linreg-fit", _linreg_fit),
    ("csvm-fit", _csvm_fit),
    ("csvm-sparse-fit", _csvm_sparse_fit),
    ("kmeans-fit", _kmeans_fit),
    ("pca-fit", _pca_fit),
    ("serve-predict", _serve_predict),
    ("ingest-fit", _ingest_fit),
    ("traced-fit", _traced_fit),
]


def iter_plans(names, device="cuda") -> Iterator[Tuple[str, "_plan.Plan"]]:
    for name, build in SCENARIOS:
        if names and name not in names:
            continue
        for i, p in enumerate(build(device)):
            yield (f"{name}" if i == 0 else f"{name}#{i}"), p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="lint the plans behind the examples and estimator fits")
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="NAME", help="run one scenario (repeatable); "
                    "known: " + ", ".join(n for n, _ in SCENARIOS))
    ap.add_argument("--fail-on", default="warn",
                    choices=list(analysis.SEVERITIES),
                    help="exit nonzero on findings at/above this severity")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="device the scenarios' arrays live on "
                    "(default: cuda)")
    args = ap.parse_args(argv)
    rules = args.rules.split(",") if args.rules else None

    failed = 0
    for name, p in iter_plans(args.scenario, args.device):
        rep = analysis.check(p, rules=rules, fail_on=args.fail_on,
                             suppress=list(WAIVERS))
        live = rep.by_rule("peak-hbm-liveness")
        print(f"== {name}: {len(p.roots)} root(s), "
              f"{p.stats.get('nodes_after', '?')} nodes ==")
        for f in live:
            naive, minimized = f.data[0], f.data[1]
            ratio = naive / minimized if minimized else 1.0
            print(f"   peak HBM: naive={naive:,} minimized={minimized:,} "
                  f"({ratio:.2f}x)")
        for f in rep.findings:
            if f.rule == "peak-hbm-liveness" and f.severity == "info":
                continue
            print(f"   {f}")
        for f in rep.suppressed:
            print(f"   [waived: {WAIVERS[f.token]}] {f.token}")
        if not rep.ok:
            failed += len(rep.failing)
    if failed:
        print(f"\n{failed} unsuppressed finding(s) at/above "
              f"--fail-on={args.fail_on}", file=sys.stderr)
        return 1
    print("\nall plans clean.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
