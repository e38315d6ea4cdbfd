"""The port's plan analysis against the JAX package's, case by case.

One counterpart of each test of ``tests/test_analysis.py`` (one known-bad
fixture per rule, the clean plan, the Report API, the invariant
coordinates, the CLI) and of the two ``costmodel-drift`` rule cases of
``tests/test_obs.py``, on the port alone (``device="cpu"``).  Then one
parity case per CLI scenario: both packages build the scenario's plans
from one NumPy input and every rule runs over them; the findings agree in
rule, severity, site and ``data``, except the deviations of ``ROADMAP.md``
§3, named one by one in :data:`DEVIATIONS`.  Last, the graph of a small
plan holds exactly one ``kernel:*`` node per kernel-wrapper call, with none
of the plain version's inner ops.

Where the port's graph differs from the reference's jaxpr/HLO by design,
the case pins the port's count: a fused Blockwise is one composed function
of eager torch ops, each writing its output (the six-op chain writes 5
full-grid intermediates where XLA's fusion writes none).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("scipy.sparse")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.analysis as janalysis  # noqa: E402
import repro.analysis.__main__ as jcli  # noqa: E402
import repro.core as jx  # noqa: E402
import repro_torch as pt  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.core import costmodel, expr as E, plan as P  # noqa: E402
from repro_torch.core import sparse as psparse  # noqa: E402
from repro_torch.core.dsarray import DsArray, PAD_DIRTY, PAD_ZERO  # noqa: E402
from repro_torch.kernels.matmul import ops as mops  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

RNG = np.random.default_rng(20261019)

#: the full-grid writes of the six-op chain's fused body in the port: the
#: outputs of add, mul, sub, abs and mul (the last add writes the result)
SIX_OP_WRITES = 5
FUSED_TOKEN = "no-full-grid-intermediate@entry:fused-step-outputs"


def mk(n, m, bn, bm):
    x = RNG.normal(size=(n, m)).astype(np.float32)
    return x, pt.from_array(x, (bn, bm), device="cpu")


def jmk(n, m, bn, bm):
    x = RNG.normal(size=(n, m)).astype(np.float32)
    return x, jx.from_array(jnp.asarray(x), (bn, bm))


def six_op_chain():
    """The fusion acceptance chain: 6 elementwise ops, fuses to one body."""
    _, a = mk(64, 48, 8, 8)
    return a, (((a.lazy() + a) * 2.0 - a).abs() * 0.5 + 0.25)


def random_sparse(n, m, bn, bm, density):
    x = ((RNG.random((n, m)) < density) * RNG.normal(size=(n, m)))
    return pt.from_array(x.astype(np.float32), (bn, bm),
                         device="cpu").tosparse()


# ---------------------------------------------------------------------------
# Registry + clean plan
# ---------------------------------------------------------------------------


def test_registry_ships_the_contracted_rules():
    assert analysis.all_rule_ids() == janalysis.all_rule_ids()
    ids = set(analysis.all_rule_ids())
    assert {"no-densify", "no-full-grid-intermediate", "pad-soundness",
            "remask-budget", "recompile-hazard",
            "peak-hbm-liveness", "costmodel-drift"} <= ids
    for rule in analysis.get_rules():
        ref = janalysis.get_rules([rule.id])[0]
        assert rule.severity == ref.severity
        assert rule.needs == tuple({"jaxpr": "graph", "hlo": "graph"}.get(n, n)
                                   for n in ref.needs)


def test_clean_plan_is_silent():
    """All rules over the fused 6-op chain: nothing above info but the
    port's recorded deviation (the fused body's eager intermediates), and
    with that one token waived the report passes at ``warn``."""
    _, r = six_op_chain()
    rep = analysis.check(r, fail_on="warn")
    above = [f for f in rep.findings if f.severity != "info"]
    assert [(f.token, f.data) for f in above] == \
        [(FUSED_TOKEN, (SIX_OP_WRITES, 0))], rep.render()
    waived = analysis.check(r, fail_on="warn", suppress=[FUSED_TOKEN])
    assert waived.ok, waived.render()
    assert all(f.severity == "info" for f in waived.findings)


# ---------------------------------------------------------------------------
# no-densify
# ---------------------------------------------------------------------------


def test_no_densify_fires_on_silent_densify():
    """A Blockwise whose fn densifies internally — no Densify node claims
    the conversion, so both planes flag it."""
    s = random_sparse(32, 32, 8, 8, 0.1)
    bad = E.Blockwise(lambda b: psparse._to_dense_blocks(b) * 2,
                      (E.Leaf(s),), ("bad-densify",))
    rep = analysis.check(P.Plan([bad]), rules=["no-densify"])
    assert not rep.ok
    assert all(f.rule == "no-densify" for f in rep.findings)
    assert any(f.severity == "error" for f in rep.findings)
    assert any(f.site.startswith("op:") for f in rep.findings), rep.render()


def test_no_densify_silent_on_explicit_densify():
    """`sp + scalar` records an explicit Densify node: the conversion is
    claimed, no finding."""
    s = random_sparse(32, 32, 8, 8, 0.1)
    rep = analysis.check(s.lazy() + 1.0, rules=["no-densify"])
    assert rep.ok and not rep.findings, rep.render()


def test_no_densify_silent_on_spmm():
    """sp @ dense contracts the stored entries (``sparse_contract``) — a
    documented sparse sink, never flagged."""
    s = random_sparse(24, 24, 8, 8, 0.2)
    _, w = mk(24, 8, 8, 8)
    rep = analysis.check(s.lazy() @ w, rules=["no-densify"])
    assert rep.ok and not rep.findings, rep.render()


# ---------------------------------------------------------------------------
# no-full-grid-intermediate
# ---------------------------------------------------------------------------


def _sort_add(b):
    return b + torch.sort(b, dim=-1).values


def _unfusable_chain():
    _, a = mk(64, 48, 8, 8)
    # a per-block sort inside the chain: XLA cannot fuse it; the port's
    # composed body writes it like every other op
    x = (a.lazy() + 1.0).map_blocks(_sort_add)
    return a, x + 0.5


def test_full_grid_intermediate_fires_on_unfusable_body():
    _, bad = _unfusable_chain()
    rep = analysis.check(bad, rules=["no-full-grid-intermediate"])
    assert not rep.ok
    f = rep.findings[0]
    assert f.rule == "no-full-grid-intermediate" and f.severity == "error"
    n_defs, budget = f.data
    assert n_defs > budget
    # add(+1), the sort (values and indices: one op), the add: 3 writes;
    # the map_blocks step writes the sort besides its output, so the site
    # is the reference's shape, and no waiver names it
    assert f.data == (3, 0) and f.site == "entry:[8, 6, 8, 8]"
    _, ja = jmk(64, 48, 8, 8)
    jbad = (ja.lazy() + 1.0).map_blocks(lambda b: b + jnp.sort(b, axis=-1))
    ref = janalysis.check(jbad + 0.5, rules=["no-full-grid-intermediate"])
    assert [g.site for g in ref.findings] == [f.site]
    assert not analysis.check(bad, suppress=list(cli.WAIVERS)).ok


def test_full_grid_intermediate_waiver_is_exact():
    """The waived site holds only when every write beyond the budget is
    one fused step's own output: an unfused map_blocks that writes a sort
    besides its output, or a step of a fused chain that does, keeps the
    reference's shape site and fails under ``WAIVERS``."""
    _, a = mk(64, 48, 8, 8)
    alone = analysis.check(a.lazy().map_blocks(_sort_add),
                           rules=["no-full-grid-intermediate"],
                           suppress=list(cli.WAIVERS))
    assert [(f.token, f.data) for f in alone.failing] == [
        ("no-full-grid-intermediate@entry:[8, 6, 8, 8]", (1, 0))]
    chained = analysis.check((a.lazy() * 2.0).map_blocks(_sort_add) - 1.0,
                             rules=["no-full-grid-intermediate"],
                             suppress=list(cli.WAIVERS))
    assert [f.site for f in chained.failing] == ["entry:[8, 6, 8, 8]"]
    assert not chained.suppressed


def test_full_grid_intermediate_silent_on_fused_chain():
    """The reference is silent here (XLA fuses the chain into one loop);
    the port's composed body writes each op's output, and the rule says so
    with the count pinned (ROADMAP.md §3)."""
    _, r = six_op_chain()
    rep = analysis.check(r, rules=["no-full-grid-intermediate"])
    assert [(f.token, f.data) for f in rep.findings] == \
        [(FUSED_TOKEN, (SIX_OP_WRITES, 0))], rep.render()
    # one Blockwise of one op writes only its result: silent
    _, a = mk(64, 48, 8, 8)
    one = analysis.check(a.lazy() * 2.0, rules=["no-full-grid-intermediate"])
    assert one.ok and not one.findings, one.render()


def test_full_grid_intermediate_reduce_writes_no_masked_copy():
    """``max`` over a fused chain reads the valid elements alone (the
    blocks and the edge blocks' valid lines, as views) where the reference
    remasks its operand with -inf and XLA fuses the select into the reduce:
    no full-grid write beyond the fused body's step outputs, with a pad and
    without.  The count is pinned (ROADMAP.md §3) and the waiver holds."""
    for n, writes in ((64, (4, 1)), (60, (4, 1))):
        _, a = mk(n, n, 16, 16)
        _, b = mk(n, n, 16, 16)
        s = ((a.lazy() + b) * 2.0).abs().sqrt()
        roots = [s.sum(axis=0), s.max(axis=1), s.sum(axis=0)]
        rep = analysis.check(roots, rules=["no-full-grid-intermediate"])
        assert [(f.token, f.data) for f in rep.findings] == \
            [(FUSED_TOKEN, writes)], rep.render()
        assert analysis.check(roots, suppress=list(cli.WAIVERS)).ok
        g = P.plan_for(*roots).graph()
        assert analysis.count_selects(g) == 0


def test_assert_fused_single_body_wrapper():
    _, a = mk(64, 48, 8, 8)
    analysis.assert_fused_single_body(P.plan_for(a.lazy() * 2.0),
                                      a.blocks.shape)
    a6, r = six_op_chain()
    with pytest.raises(AssertionError, match="intermediate full-grid"):
        analysis.assert_fused_single_body(P.plan_for(r), a6.blocks.shape)
    writes = analysis.full_grid_writes(P.plan_for(r).graph(), a6.blocks.shape)
    assert len(writes) == SIX_OP_WRITES
    a2, bad = _unfusable_chain()
    with pytest.raises(AssertionError):
        analysis.assert_fused_single_body(P.plan_for(bad), a2.blocks.shape)


# ---------------------------------------------------------------------------
# pad-soundness
# ---------------------------------------------------------------------------


def _times_ones(blk):
    # breaks the (1, 1, 1, 1) probe shape: the probe cannot verify a claim
    return blk * torch.ones((8,), dtype=blk.dtype, device=blk.device)


def test_pad_soundness_fires_on_overclaimed_pad():
    """A map_blocks fn the probe cannot verify claiming PAD_ZERO, fed into a
    matmul whose mask elision would trust the claim."""
    _, a = mk(30, 30, 8, 8)
    _, b = mk(30, 30, 8, 8)
    bad = a.lazy().map_blocks(_times_ones, pad=PAD_ZERO)
    rep = analysis.check(bad @ b, rules=["pad-soundness"])
    assert not rep.ok
    assert rep.findings[0].rule == "pad-soundness"
    assert rep.findings[0].severity == "error"


def _double(b):
    return b * 2.0


def test_pad_soundness_accepts_probe_derived_and_weaker_claims():
    _, a = mk(30, 30, 8, 8)
    clean = (a.lazy() + 1.0) * 2.0              # pad probed by the recorder
    weaker = a.lazy().map_blocks(_double, pad=PAD_DIRTY)
    for target in (clean, weaker):
        rep = analysis.check(target, rules=["pad-soundness"])
        assert rep.ok and not rep.findings, rep.render()


# ---------------------------------------------------------------------------
# remask-budget
# ---------------------------------------------------------------------------


def _select_heavy(b):
    zero = torch.zeros((), dtype=b.dtype)
    return torch.where(b > 0, torch.where(b > 1, b, zero),
                       torch.where(b < -1, -b, zero))


def test_remask_budget_fires_on_select_heavy_fn():
    _, a = mk(64, 48, 8, 8)
    bad = a.lazy().map_blocks(_select_heavy)
    rep = analysis.check(bad, rules=["remask-budget"], fail_on="warn")
    assert not rep.ok
    assert rep.by_rule("remask-budget")
    count, budget = rep.by_rule("remask-budget")[0].data
    # the budget law is the costmodel's: one deferred pass per consumer
    assert budget == costmodel.chain_remask_passes(1, True, False) * 1
    assert count == 3 > budget


def test_remask_budget_silent_within_budget():
    _, r = six_op_chain()
    rep = analysis.check(r, rules=["remask-budget"])
    assert not rep.findings, rep.render()
    # the saturating float-to-int cast's three `where`s are the cast's,
    # not remasks (the reference's cast has no select)
    _, a = mk(64, 48, 8, 8)
    g = P.plan_for(a.lazy().astype(torch.int32)).graph()
    assert sum(n.name == "where" and n.scope == "cast" for n in g) == 3
    assert analysis.count_selects(g) == 0


# ---------------------------------------------------------------------------
# recompile-hazard
# ---------------------------------------------------------------------------


def test_recompile_hazard_fires_on_lambda_key():
    """A raw lambda in map_blocks bakes a fresh function object into the
    plan key: every re-recording misses the plan cache."""
    _, a = mk(32, 32, 8, 8)
    rep = analysis.check(a.lazy().map_blocks(lambda b: b + 1),
                         rules=["recompile-hazard"], fail_on="warn")
    assert not rep.ok
    assert rep.findings[0].rule == "recompile-hazard"
    assert "lambda" in rep.findings[0].message


def test_recompile_hazard_fires_on_weak_type_drift():
    """`+ 2` and `* 2.0` bake the same value at two dtypes, keying two cache
    entries per recording; the data names them as the reference does."""
    _, a = mk(32, 32, 8, 8)
    rep = analysis.check((a.lazy() + 2) * 2.0,
                         rules=["recompile-hazard"], fail_on="warn")
    assert not rep.ok
    drift = [f for f in rep.findings if "drift" in f.message]
    assert drift, rep.render()
    assert drift[0].data == (2.0, ("float64", "int64"))


def test_recompile_hazard_silent_on_named_fns_and_stable_scalars():
    _, r = six_op_chain()   # named fns + distinct scalar values only
    rep = analysis.check(r, rules=["recompile-hazard"])
    assert not rep.findings, rep.render()


# ---------------------------------------------------------------------------
# peak-hbm-liveness
# ---------------------------------------------------------------------------


def _matmul_products(order=8):
    """mi = Li @ K: each product is (n, n) — much bigger than its (n, s)
    and (s, n) factors."""
    n, s = 64, 8
    _, k = mk(s, n, 8, 8)
    return [mk(n, s, 8, 8)[1].lazy() @ k for _ in range(order)]


def test_liveness_flags_order_sensitive_dag():
    ms = _matmul_products()
    r = ms[-1]
    for m in reversed(ms[:-1]):
        r = m @ r
    rep = analysis.check(r, rules=["peak-hbm-liveness"], fail_on="warn")
    assert not rep.ok
    f = rep.findings[0]
    assert f.rule == "peak-hbm-liveness" and f.severity == "warn"
    naive, minimized = f.data[0], f.data[1]
    assert costmodel.liveness_reorder_pays(naive, minimized)
    assert naive >= 2 * minimized


def test_liveness_info_on_left_deep_chain():
    ms = _matmul_products()
    r = ms[0]
    for m in ms[1:]:
        r = r @ m
    rep = analysis.check(r, rules=["peak-hbm-liveness"], fail_on="warn")
    assert rep.ok
    f = rep.findings[0]
    assert f.severity == "info"
    assert f.data[0] == f.data[1]      # naive is already minimal


def test_liveness_numbers_for_six_op_chain():
    a, r = six_op_chain()
    rep = analysis.liveness_report(r)
    tensor = costmodel.node_live_bytes(tuple(a.blocks.shape), 4)
    assert rep.input_bytes == tensor
    assert rep.naive_peak == rep.minimized_peak == 2 * tensor
    assert not rep.reorder_pays


# ---------------------------------------------------------------------------
# Report API: severities, fail_on, suppression tokens
# ---------------------------------------------------------------------------


def test_fail_on_threshold_and_suppression():
    _, a = mk(32, 32, 8, 8)
    bad = a.lazy().map_blocks(lambda b: b + 1)   # recompile-hazard: warn
    assert analysis.check(bad, rules=["recompile-hazard"],
                          fail_on="error").ok
    rep = analysis.check(bad, rules=["recompile-hazard"], fail_on="warn")
    assert not rep.ok
    with pytest.raises(analysis.AnalysisError):
        rep.raise_if_failed()
    by_rule = analysis.check(bad, rules=["recompile-hazard"],
                             fail_on="warn", suppress=["recompile-hazard"])
    assert by_rule.ok and by_rule.suppressed
    token = rep.findings[0].token
    by_token = analysis.check(bad, rules=["recompile-hazard"],
                              fail_on="warn", suppress=[token])
    assert by_token.ok and by_token.suppressed


def test_check_coerces_dsarray_and_sequences():
    _, a = mk(16, 16, 8, 8)
    assert analysis.check(a).ok
    rep = analysis.check([a.lazy() + 1.0, a.lazy().sum()])
    assert rep.ok
    assert isinstance(analysis.PlanView.of(a.lazy() + 1.0).graph(),
                      analysis.Graph)


# ---------------------------------------------------------------------------
# Invariant coordinates: check_invariants names the bad block
# ---------------------------------------------------------------------------


def test_dense_invariant_failure_names_block_coordinates():
    _, a = mk(10, 10, 8, 8)
    blocks = a.ensure_zero_pad().blocks.clone()
    blocks[1, 1, 7, 7] = 5.0          # global (15, 15): inside the pad
    with pytest.raises(AssertionError) as ei:
        bad = DsArray(blocks, a.grid, a.pad_state)
        bad.check_invariants()
    msg = str(ei.value)
    assert "block (1, 1)" in msg and "offset (7, 7)" in msg, msg


def test_sparse_invariant_failure_names_block_and_slot():
    _, a = mk(4, 4, 4, 4)
    data = torch.tensor([[[1.0, 2.0]]])                     # (1, 1, 2)
    indices = torch.tensor([[[[0, 0], [9, 0]]]], dtype=torch.int32)
    sp = psparse.StackedCOO(data, indices, (1, 1, 4, 4), False, False)
    with pytest.raises(AssertionError, match=r"block \(0, 0\) slot 1"):
        DsArray(sp, a.grid, PAD_ZERO).check_invariants()


# ---------------------------------------------------------------------------
# costmodel-drift (tests/test_obs.py's two rule cases)
# ---------------------------------------------------------------------------


def test_costmodel_drift_rule_clean_on_real_plans():
    _, r = six_op_chain()
    rep = analysis.check(P.plan_for(r), rules=["costmodel-drift"])
    assert rep.ok and rep.findings == []


def test_costmodel_drift_rule_fires_when_law_is_broken(monkeypatch):
    real = costmodel.node_live_bytes
    # a 2x-wrong byte law: every prediction is half reality — well beyond
    # the 1.25x tolerance, so every non-leaf node must be flagged
    monkeypatch.setattr(costmodel, "node_live_bytes",
                        lambda *a, **k: real(*a, **k) / 2.0)
    _, r = six_op_chain()
    rep = analysis.check(P.plan_for(r), rules=["costmodel-drift"],
                         fail_on="warn")
    assert not rep.ok
    assert rep.findings and all(f.rule == "costmodel-drift"
                                for f in rep.findings)
    assert "2.00x" in str(rep.findings[0])


# ---------------------------------------------------------------------------
# CLI smoke
# ---------------------------------------------------------------------------


def test_cli_six_op_chain_scenario(capsys):
    rc = cli.main(["--device", "cpu", "--scenario", "six-op-chain"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "peak HBM: naive=" in out
    assert "all plans clean" in out
    assert f"] {FUSED_TOKEN}" in out
    assert all("@" in t and not t.endswith("@") for t in cli.WAIVERS)
    assert not set(cli.WAIVERS) & set(analysis.all_rule_ids())


# ---------------------------------------------------------------------------
# Parity with the reference on the CLI scenarios
# ---------------------------------------------------------------------------

#: findings of one package alone, per scenario: (scenario, plan index) ->
#: {"port": tokens only the port reports, "ref": tokens only the
#: reference reports}; each is a deviation of ROADMAP.md §3
DEVIATIONS = {
    # fused chains write their intermediates (§3 "Fused chains write
    # their intermediates")
    ("six-op-chain", 0): {"port": {FUSED_TOKEN}},
    ("quickstart", 0): {"port": {FUSED_TOKEN}},
    # the dense K-means fit records no ‖x‖² plan: the assign kernel forms
    # ‖x‖² itself (§3 "The dense K-means fit records no plan")
    ("kmeans-fit", 0): {"ref": {"peak-hbm-liveness@plan"}},
    ("traced-fit", 0): {"ref": {"peak-hbm-liveness@plan"}},
}


def _inputs_from_numpy(monkeypatch):
    """The reference's two jax.random draws of the CLI replaced by the
    port's NumPy draws, so both packages lint plans over one input."""
    real_normal = jax.random.normal

    def normal(key, shape, *a, **k):
        if tuple(shape) != (64, 48):            # PCA's start: not compared
            return real_normal(key, shape, *a, **k)
        return jnp.asarray(np.random.default_rng(0).standard_normal(
            (64, 48), np.float32))

    def random_array(key, shape, block_shape):
        assert tuple(shape) == (200, 80)
        return jx.from_array(jnp.asarray(np.random.default_rng(1).random(
            (200, 80), np.float32)), block_shape)

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jcli, "random_array", random_array)


def _findings(rep):
    return {(f.rule, f.severity, f.site, tuple(f.data)) for f in rep.findings}


@pytest.mark.parametrize("name", [n for n, _ in cli.SCENARIOS])
def test_cli_scenario_findings_equal_reference(name, monkeypatch):
    _inputs_from_numpy(monkeypatch)
    ref_plans = dict(jcli.SCENARIOS)[name]()
    port_plans = dict(cli.SCENARIOS)[name]("cpu")
    for i in range(max(len(ref_plans), len(port_plans))):
        dev = DEVIATIONS.get((name, i), {})
        ref = (_findings(janalysis.check(ref_plans[i]))
               if i < len(ref_plans) else set())
        got = (_findings(analysis.check(port_plans[i]))
               if i < len(port_plans) else set())
        only_port = {f for f in got - ref}
        only_ref = {f for f in ref - got}
        assert {f"{r}@{s}" for r, _, s, _ in only_port} == \
            dev.get("port", set()), (name, i, only_port)
        assert {f"{r}@{s}" for r, _, s, _ in only_ref} == \
            dev.get("ref", set()), (name, i, only_ref)
    if name in ("six-op-chain", "quickstart"):
        # the deviation's own finding: the port's count, pinned
        f = [f for f in analysis.check(port_plans[0]).findings
             if f.token == FUSED_TOKEN]
        assert f and f[0].data == ((SIX_OP_WRITES, 0) if name == "six-op-chain"
                                   else (2, 1))


# ---------------------------------------------------------------------------
# Kernel calls are graph nodes
# ---------------------------------------------------------------------------


def test_graph_has_one_kernel_node_per_wrapper_call():
    """On the CPU every kernel wrapper runs its plain version; the graph
    keeps each call as ONE ``kernel:*`` node with the call's outputs, and
    none of the plain version's inner ops (the einsum's bmm, its permutes
    and casts)."""
    _, a = mk(24, 16, 8, 8)
    _, b = mk(16, 8, 8, 8)
    p = P.plan_for(a.lazy() @ b, a.lazy().T @ a, (a.lazy() * 2.0).sum())
    before = mops._DISPATCHES.as_dict()["dispatch_plain"]
    g = p.graph()
    calls = mops._DISPATCHES.as_dict()["dispatch_plain"] - before
    kernels = [n for n in g if n.kind == "kernel"]
    assert calls == 2
    assert [n.op for n in kernels] == ["kernel:stacked_matmul"] * calls
    assert sorted(n.shapes for n in kernels) == [((2, 2, 8, 8),),
                                                 ((3, 1, 8, 8),)]
    assert not {"bmm", "mm", "einsum"} & {n.name for n in g}, \
        sorted({n.op for n in g})
    # each op is tagged with the plan node that dispatched it
    nodes = analysis.PlanView.of(p).nodes
    for n in kernels:
        assert isinstance(nodes[n.owner], E.MatMul)
    # the same for the K-means assign and the LM kernels' wrappers
    from repro_torch.kernels.kmeans.ops import kmeans_assign
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd.ops import ssd_chunk
    x = torch.randn(40, 6)
    q = torch.randn(1, 2, 16, 8)
    ssd_in = (torch.randn(2, 32, 4), torch.rand(2, 32), -torch.rand(2),
              torch.randn(2, 32, 8), torch.randn(2, 32, 8))
    for name, fn, args, kw in (
            ("kmeans_assign", kmeans_assign, (x, x[:3]), {}),
            ("flash_attention", flash_attention, (q, q, q), {}),
            ("ssd_chunk", ssd_chunk, ssd_in, {"chunk": 16})):
        g = analysis.trace_ops(fn, *args, **kw)
        ks = [n for n in g if n.kind == "kernel"]
        assert [n.op for n in ks] == [f"kernel:{name}"], str(g)
        assert all(n.owner is None for n in g)
    with pytest.raises(ValueError, match="meta"):
        analysis.trace_ops(torch.neg, torch.empty(2, device="meta"))
