"""The paper's task-complexity laws + their TPU collective-byte analogues.

On PyCOMPSs the cost of a distributed-array op is (a) the number of tasks the
scheduler must dispatch (~milliseconds each at scale, the paper's dominant
overhead in Figs. 6/8) and (b) the bytes moved between workers.  On a TPU pod
dispatch is compiled away, so the surviving analogue of (a)+(b) is the bytes
crossing ICI links per collective.  Benchmarks plot BOTH models: the task law
reproduces the paper's figures; the byte law predicts the TPU behaviour that
the roofline harness then measures from compiled HLO.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Task-count laws, verbatim from the paper.
# ---------------------------------------------------------------------------


def dataset_transpose_tasks(n_subsets: int) -> int:
    """Paper §5.2: split each Subset into N parts (N^2) + merge (N)."""
    return n_subsets * n_subsets + n_subsets


def dsarray_transpose_tasks(grid_rows: int, grid_cols: int) -> int:
    """Paper §5.2: one task per row of blocks (local transpose + grid
    permutation; the permutation is metadata-only)."""
    del grid_cols
    return grid_rows


def dataset_shuffle_tasks(n_subsets: int, subset_size: int) -> int:
    """Paper §5.4: N * min(N, S) splits + N merges."""
    return n_subsets * min(n_subsets, subset_size) + n_subsets


def dsarray_shuffle_tasks(grid_rows: int) -> int:
    """Paper §5.4: 2N thanks to COLLECTION_IN/OUT multi-I/O tasks."""
    return 2 * grid_rows


def dataset_rowsum_tasks(n_subsets: int) -> int:
    """Paper Fig. 3: one partial-sum task per Subset + a reduction tree."""
    return n_subsets + (n_subsets - 1)


def dsarray_colsum_tasks(grid_rows: int, grid_cols: int) -> int:
    """Paper Fig. 5: one task per column of blocks."""
    del grid_rows
    return grid_cols


def dataset_slice_tasks(n_subsets: int) -> int:
    """Row-partitioned Datasets must gather every Subset, slice the merged
    copy, then re-split: N gathers + 1 slice + N splits (paper Fig. 3
    structure applied to selection)."""
    return 2 * n_subsets + 1


def dsarray_slice_tasks(sel_grid_rows: int, sel_grid_cols: int) -> int:
    """Block-aligned slice: one task per SELECTED block; unselected blocks are
    never touched (paper §5: per-block ops)."""
    return sel_grid_rows * sel_grid_cols


def dsarray_filter_tasks(out_grid_rows: int, grid_cols: int) -> int:
    """Integer-array row selection: one gather task per output block row,
    across each block column."""
    return out_grid_rows * grid_cols


def dsarray_rechunk_tasks(grid_rows: int, grid_cols: int) -> int:
    """Evenly-dividing rechunk: one regroup task per source block (each
    element moves exactly once).  The seed materialize path was 2 global
    relayouts (O(N) twice) plus a host gather."""
    return grid_rows * grid_cols


def dsarray_concat_tasks(n_parts: int) -> int:
    """Aligned concat: one grid-stack task per part (metadata + placement);
    the Dataset append must copy every Subset of both operands."""
    return n_parts


def dataset_als_tasks(n_subsets: int, iters: int) -> int:
    """ALS on Datasets: transpose copy up front + per-iteration row/col solves.
    The transpose dominates (paper §5.3)."""
    return dataset_transpose_tasks(n_subsets) + iters * 2 * n_subsets


def dsarray_als_tasks(grid: int, iters: int) -> int:
    return iters * 2 * grid


# ---------------------------------------------------------------------------
# PyCOMPSs wall-time model (fits the paper's figures):
#   t = tasks * overhead / min(cores, parallel_width) + compute + bytes/bw
# The paper attributes the Dataset collapse to scheduler overhead growing with
# task count; overhead_s ~ 2-10 ms/task reproduces the reported 4.5 h -> 7 s.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SchedulerModel:
    overhead_s: float = 4e-3        # per-task scheduling cost (master-side, serial)
    worker_overhead_s: float = 1e-3  # per-task worker-side launch cost


def pycompss_time(
    tasks: int,
    compute_s_per_task: float,
    cores: int,
    model: SchedulerModel = SchedulerModel(),
) -> float:
    serial = tasks * model.overhead_s  # master dispatch is serial
    parallel = tasks * (compute_s_per_task + model.worker_overhead_s) / max(1, cores)
    return serial + parallel


# ---------------------------------------------------------------------------
# TPU collective-byte laws for the same ops (what the roofline measures).
# All are per-device bytes; mesh (dn, dm), element size e.
# ---------------------------------------------------------------------------


def tpu_transpose_bytes(n: int, m: int, e: int, dn: int, dm: int) -> float:
    """all_to_all over both mesh axes: each device keeps 1/(dn*dm) of its shard
    and sends the rest; per-device shard is n*m*e/(dn*dm)."""
    shard = n * m * e / (dn * dm)
    return shard * (1.0 - 1.0 / (dn * dm))


def tpu_colsum_bytes(n: int, m: int, e: int, dn: int, dm: int) -> float:
    """psum over the `data` axis of a (1, m/dm) partial per device:
    ring all-reduce moves 2*(dn-1)/dn of the reduced tensor."""
    del n
    reduced = m * e / dm
    return reduced * 2.0 * (dn - 1) / dn


def tpu_shuffle_bytes(n: int, m: int, e: int, dn: int, dm: int) -> float:
    """row pseudo-shuffle = all_to_all along `data`: ~full shard leaves."""
    del dm
    shard = n * m * e / dn
    return shard * (1.0 - 1.0 / dn)


def tpu_summa_bytes(n: int, k: int, m: int, e: int, dn: int, dm: int) -> float:
    """SUMMA C[n,m] = A[n,k] @ B[k,m] on an (dn, dm) mesh: every device
    receives the A-panel row broadcast (n*k/dn per step, dm steps → n*k*e/dn)
    and the B-panel column broadcast (k*m*e/dm)."""
    return n * k * e / dn + k * m * e / dm


def tpu_aligned_slice_bytes(rows: int, cols: int, e: int, dn: int, dm: int) -> float:
    """Block-aligned slice on an unchanged mesh: a grid slice keeps every
    selected block on its device — zero collective bytes.  (Rebalancing the
    smaller grid across the mesh, if requested, moves at most the selected
    bytes once: rows*cols*e/(dn*dm) per device.)"""
    del rows, cols, e, dn, dm
    return 0.0


def tpu_filter_bytes(out_rows: int, m: int, e: int, dn: int, dm: int) -> float:
    """Row gather: each output row is fetched from the device owning its
    source block — worst case the full output crosses the mesh once."""
    return out_rows * m * e / (dn * dm)


def tpu_rechunk_bytes(n: int, m: int, e: int, dn: int, dm: int,
                      dividing: bool = True) -> float:
    """Evenly-dividing rechunk is a local regroup (0 bytes — the grid->device
    map is refined in place); the gather fallback moves each shard once."""
    if dividing:
        return 0.0
    return n * m * e / (dn * dm)


def collective_time_s(bytes_per_device: float, link_bw: float = 50e9) -> float:
    return bytes_per_device / link_bw


# ---------------------------------------------------------------------------
# Local-GEMM laws: fused stacked Pallas kernel vs the per-grid-k loop.
#
# The loop-of-vmaps path launched one 2-D GEMM per grid-k step and
# accumulated C in HBM (write the partial, read it back next step); the
# fused stacked kernel reduces grid-k x block-k inside one launch with the
# accumulator resident in VMEM, so C is written exactly once.
# ---------------------------------------------------------------------------


def stacked_gemm_flops(gi: int, gj: int, gk: int,
                       bn: int, bk: int, bm: int) -> float:
    """MACs x2 for C(gi*bn, gj*bm) = A(gi*bn, gk*bk) @ B(gk*bk, gj*bm)."""
    return 2.0 * gi * gj * gk * bn * bk * bm


def stacked_gemm_hbm_bytes(gi: int, gj: int, gk: int, bn: int, bk: int,
                           bm: int, e: int, fused: bool = True) -> float:
    """HBM traffic of the local blocked GEMM, element size ``e``.

    Every C tile streams its A panel row (re-read per gj) and B panel column
    (re-read per gi).  Fused: C written once.  Unfused (the old loop): every
    grid-k step writes the full C partial and re-reads it for the add —
    (2*gk - 1)x the C traffic, the term the fused kernel deletes.
    """
    a_reads = gi * gk * bn * bk * gj * e
    b_reads = gk * gj * bk * bm * gi * e
    c_bytes = gi * gj * bn * bm * e
    if fused:
        return a_reads + b_reads + c_bytes
    return a_reads + b_reads + (2 * gk - 1) * c_bytes


def gemm_kernel_launches(gk: int, fused: bool = True) -> int:
    """Kernel-dispatch law: the fused kernel is 1 launch however deep the
    grid-k reduction; the loop path paid one per grid-k step."""
    return 1 if fused else gk


# ---------------------------------------------------------------------------
# Remask laws: pad-state tracking vs unconditional per-op re-masking.
# ---------------------------------------------------------------------------


def remask_pass_bytes(n: int, m: int, e: int) -> float:
    """One mask pass = read + write of the padded tensor (the per-axis masks
    are O(sqrt N) and free by comparison)."""
    return 2.0 * n * m * e


def chain_remask_passes(n_ops: int, pad_tracked: bool = True,
                        zero_preserving: bool = True) -> int:
    """Mask passes over an ``n_ops``-long elementwise chain ending in a
    consumer (reduction / matmul / structural op).

    Untracked (seed): one pass per op.  Tracked: zero-preserving chains pay
    none (the consumer sees pad_state == identity); otherwise the consumer
    pays exactly one deferred pass, regardless of chain length.
    """
    if not pad_tracked:
        return n_ops
    return 0 if zero_preserving else min(1, n_ops)


# ---------------------------------------------------------------------------
# Sparse-block (BCOO) laws: when does the bcoo format pay?
#
# A stacked BCOO stores, per entry, the value plus a 2-D block-local index
# (element size e + 2*idx_e bytes vs e for dense), so storage — and the HBM
# traffic of every streaming op, which is what bounds elementwise/matvec on
# TPU — shrinks only below a crossover density.  FLOP-wise spmm scales with
# nnz directly.  ``core.io.from_array_auto`` consults these laws to pick a
# ``block_format``, and ``benchmarks/bench_sparse.py`` measures the real
# crossover against them.
# ---------------------------------------------------------------------------


def bcoo_bytes(nnz: int, e: int, idx_e: int = 4) -> float:
    """Stored bytes of a stacked BCOO with ``nnz`` entries (data + the
    per-entry (row, col) block-local index pair)."""
    return nnz * (e + 2.0 * idx_e)


def dense_stacked_bytes(gn: int, gm: int, bn: int, bm: int, e: int) -> float:
    return float(gn) * gm * bn * bm * e


def sparse_storage_crossover_density(e: int, idx_e: int = 4) -> float:
    """Density below which bcoo storage (and thus the bytes every streaming
    op moves) beats dense: d* = e / (e + 2*idx_e) — 1/3 for f32 data with
    i32 indices.  This is the io auto-pick default threshold."""
    return e / (e + 2.0 * idx_e)


def spmm_flops(nnz: int, out_cols: int) -> float:
    """MACs x2 of ``sp @ dense``: each stored entry multiplies one dense
    row-slice of the rhs (``out_cols`` wide) — nnz-proportional, vs the
    dense ``2*n*k*out_cols``."""
    return 2.0 * nnz * out_cols


def spmm_hbm_bytes(nnz: int, k: int, m: int, out_rows: int, e: int,
                   idx_e: int = 4) -> float:
    """HBM traffic of ``sp[out_rows, k] @ dense[k, m]``: stream the stored
    entries once (value + index), the dense rhs once, write the dense
    result once."""
    return bcoo_bytes(nnz, e, idx_e) + float(k) * m * e + float(out_rows) * m * e


def sparse_matmul_crossover_density(k: int, m: int, out_rows: int, e: int,
                                    idx_e: int = 4) -> float:
    """Density where spmm HBM bytes equal the dense GEMM's A-read bytes
    (rhs/result traffic is common to both): nnz*(e+2*idx_e) = out_rows*k*e
    → d* = e/(e+2*idx_e), the storage crossover again — spmm is
    memory-bound at ds-array block sizes, so bytes ARE the model."""
    del k, m, out_rows
    return sparse_storage_crossover_density(e, idx_e)


def bcoo_recompaction_saved_bytes(nse: int, block_elems: int, n_blocks: int,
                                  e: int = 4, idx_e: int = 4) -> float:
    """Bytes a lazy nse re-compaction deletes from every later streaming op.

    Recorded sparse± nodes CONCATENATE entry lists, so a chain's capacity
    grows as the sum of its operands' nse — but a block can hold at most
    ``block_elems`` distinct positions, so ``sparse.canonicalize`` with a
    static ``nse = block_elems`` target always preserves the values while
    capping the capacity.  Everything past the compaction point streams
    ``bcoo_bytes(target)`` instead of ``bcoo_bytes(nse)`` per block.
    """
    target = min(nse, block_elems)
    return n_blocks * (bcoo_bytes(nse, e, idx_e) - bcoo_bytes(target, e, idx_e))


def bcoo_recompaction_pays(nse: int, block_elems: int, e: int = 4,
                           idx_e: int = 4) -> bool:
    """Should the lazy recorder insert an nse-shrinking canonicalize node
    after a sparse± Blockwise?  Iff the accumulated capacity exceeds the
    per-block position bound — beyond it the extra slots are duplicates by
    pigeonhole and every consumer of the chain pays their bytes for nothing
    (at ``nse = block_elems`` the BCOO already stores ``(e + 2*idx_e)/e``x
    the dense block, so growth past the bound is pure waste)."""
    return bcoo_recompaction_saved_bytes(nse, block_elems, 1, e, idx_e) > 0


def tosparse_pays(density: float, e: int = 4, idx_e: int = 4,
                  streaming_ops: int = 1) -> bool:
    """Should an array be converted to bcoo?  The conversion itself costs
    one dense read; it pays when the per-op byte saving, times the number
    of streaming ops that will consume the sparse form, beats that.  With
    ``streaming_ops >= 1`` the break-even is the storage crossover shifted
    by the one-off read: d* * s/(s+1) is conservative; for the io auto-pick
    (arrays loaded once, consumed many times) the plain crossover is used.
    """
    d_star = sparse_storage_crossover_density(e, idx_e)
    return density < d_star * streaming_ops / (streaming_ops + 1.0) \
        if streaming_ops < 4 else density < d_star


# ---------------------------------------------------------------------------
# Lazy-plan laws: what record→optimize→fuse buys over eager dispatch.
#
# An eager elementwise chain of L ops issues L dispatches, each reading and
# writing the full padded stacked tensor in HBM; the lazy plan fuses the
# chain into ONE per-block function inside one jit, so the tensor is read
# once and only the final result is written.  These laws quantify the three
# axes the optimizer reports: plan size (nodes), HBM traffic, and dispatch
# (launch) count.
# ---------------------------------------------------------------------------


def plan_nodes_after_fusion(n_elementwise: int, n_other: int = 0) -> int:
    """Non-leaf plan nodes after optimization: a run of ``n_elementwise``
    fusible Blockwise nodes collapses to 1; reductions/matmuls/structural
    nodes (``n_other``) survive as fusion barriers."""
    return (1 if n_elementwise else 0) + n_other


def lazy_chain_hbm_bytes(n_ops: int, n: int, m: int, e: int,
                         fused: bool = True) -> float:
    """HBM traffic of an ``n_ops`` elementwise chain over an (n, m) array,
    element size ``e``.  Eager: every op reads its input and writes its
    result — ``2·L`` passes.  Fused: one read of the operand + one write of
    the result, independent of chain length (intermediates live in
    registers/VMEM inside the single fused body)."""
    per_pass = float(n) * m * e
    if fused:
        return 2.0 * per_pass
    return 2.0 * n_ops * per_pass


def lazy_chain_hbm_saved(n_ops: int, n: int, m: int, e: int) -> float:
    """Bytes the fused plan deletes vs eager dispatch (the headline the
    ``bench_lazy`` speedup should track on memory-bound chains)."""
    return (lazy_chain_hbm_bytes(n_ops, n, m, e, fused=False)
            - lazy_chain_hbm_bytes(n_ops, n, m, e, fused=True))


def lazy_chain_launches(n_ops: int, fused: bool = True) -> int:
    """Dispatch law: the compiled plan is ONE launch however long the chain
    (and a cache hit skips re-tracing); eager pays one per op — the TPU
    analogue of the paper's per-task scheduler overhead (Figs. 6/8)."""
    return 1 if fused else n_ops


def merged_reduction_passes(n_reductions: int, merged: bool = True) -> int:
    """Sibling reductions over the same operand: the plan evaluates the
    shared operand (and any fused chain feeding it) once for all of them;
    eager evaluates it per reduction."""
    return 1 if merged else max(1, n_reductions)


# ---------------------------------------------------------------------------
# Estimator laws: CSVM cascade + random-forest histogram growth.
#
# The estimator layer (repro.estimators) expresses whole fit loops over the
# ds-array primitives above; these laws predict the per-iteration cost the
# benchmarks (benchmarks/bench_estimators.py) then measure.  The cascade's
# dominant op is the data-vs-model kernel matrix K(X, SV) — one sp@dense
# bcoo_dot_general for BCOO-blocked X, so its bytes follow the spmm laws —
# and the forest's is one histogram contraction per tree level.
# ---------------------------------------------------------------------------


def csvm_kernel_flops(n: int, m: int, n_sv: int) -> float:
    """MACs x2 of the cascade's global kernel block K(X, SV) = X @ SVᵀ
    (dense X); the RBF exponentiation adds O(n*n_sv), negligible."""
    return 2.0 * n * m * n_sv


def csvm_kernel_flops_sparse(nnz: int, n_sv: int) -> float:
    """Sparse X: each stored entry meets every SV column once —
    nnz-proportional, the reason the cascade was the sparse backend's
    target workload (paper §6)."""
    return spmm_flops(nnz, n_sv)


def csvm_kernel_hbm_bytes(n: int, m: int, n_sv: int, e: int,
                          nnz: int = 0, idx_e: int = 4) -> float:
    """HBM traffic of one K(X, SV) evaluation: stream the data matrix once
    (value+index stream for BCOO when ``nnz`` > 0, dense rows otherwise),
    the small SV panel once, write the (n, n_sv) kernel block."""
    data = bcoo_bytes(nnz, e, idx_e) if nnz else float(n) * m * e
    return data + float(n_sv) * m * e + float(n) * n_sv * e


def csvm_cascade_node_flops(s: int, m: int, solver_iters: int) -> float:
    """One cascade node: an (s, s) kernel build (2*s²*m) plus
    ``solver_iters`` dual projected-gradient steps (one (s, s) matvec
    each)."""
    return 2.0 * s * s * m + solver_iters * 2.0 * s * s


def csvm_cascade_fit_flops(n: int, m: int, arity: int, sv_cap: int,
                           solver_iters: int, chunks: int) -> float:
    """One cascade pass: ``chunks`` level-0 nodes of ~n/chunks (+fed-back
    SV) rows, then a merge tree of arity-way nodes over capped SV sets
    (node size ≤ arity * sv_cap, ~chunks/(arity-1) merge nodes)."""
    s0 = n // max(1, chunks) + sv_cap
    level0 = chunks * csvm_cascade_node_flops(s0, m, solver_iters)
    merge_nodes = max(0, (chunks - 1) // max(1, arity - 1))
    merges = merge_nodes * csvm_cascade_node_flops(arity * sv_cap, m,
                                                   solver_iters)
    return level0 + merges


def forest_histogram_passes(n_estimators: int, max_depth: int) -> int:
    """Histogram tree growth reads the binned code tensor once per level per
    forest (trees share the pass: the level contraction carries the tree dim)
    — vs one pass per (tree, level, node) for naive per-node partitioning."""
    del n_estimators
    return max_depth


def forest_level_flops(n: int, m: int, bins: int, classes: int,
                       nodes: int, trees: int) -> float:
    """One level's histogram contraction: every (sample, feature) pair
    scatters its bin count into (tree, node, class) cells — the einsum is
    n*m*bins*classes*trees MACs x2 bounded by the one-hot sparsity (each
    sample hits ONE node and ONE class, so the effective work is
    n*m*bins*trees*2)."""
    del classes, nodes
    return 2.0 * n * m * bins * trees


# ---------------------------------------------------------------------------
# Liveness laws: peak HBM of a plan under a static execution order.
#
# Dispatch on TPU is compiled away, but HBM is not: a plan's intermediates
# are live from the eqn that defines them to their last consumer, so the
# EXECUTION ORDER decides the peak resident bytes — dask computes exactly
# this in order.py for its scheduler, and the ROADMAP's multi-host item
# needs it to bound per-host block footprint.  ``repro.analysis.liveness``
# simulates both the naive emission order and a Sethi-Ullman-style
# minimizing order using these byte laws per node.
# ---------------------------------------------------------------------------


def node_live_bytes(shape4, e: int, nse: int = None, idx_e: int = 4) -> float:
    """Resident HBM bytes of one plan node's output: dense stacked tensor,
    or per-block BCOO entries (value + 2-D index) when ``nse`` is given."""
    gn, gm, bn, bm = shape4
    if nse is not None:
        return float(gn) * gm * bcoo_bytes(nse, e, idx_e)
    return dense_stacked_bytes(gn, gm, bn, bm, e)


#: reordering is worth surfacing when the naive order's peak is at least
#: this factor above the liveness-minimizing order's.
PEAK_REORDER_FACTOR = 2.0


def liveness_reorder_pays(naive_peak: float, ordered_peak: float,
                          factor: float = PEAK_REORDER_FACTOR) -> bool:
    """Does a liveness-minimizing topological order pay?  True when the
    naive child-first emission order holds ``factor``x (default 2x) the
    peak bytes of the reordered schedule."""
    if ordered_peak <= 0:
        return False
    return naive_peak >= factor * ordered_peak


#: tolerated measured/predicted byte ratio per plan node before the
#: ``costmodel-drift`` analysis rule fires.  The byte laws above are exact
#: for the two block representations (dense stacked tensor, stacked BCOO
#: values + 2-D int32 indices), so on main the measured footprint matches
#: the prediction bit for bit and any drift means a representation or law
#: changed without the other — the factor only absorbs backend-padded
#: layouts, not modeling error.
COSTMODEL_DRIFT_FACTOR = 1.25


def costmodel_drift_ok(predicted_bytes: float, measured_bytes: float,
                       factor: float = COSTMODEL_DRIFT_FACTOR) -> bool:
    """Is one node's measured output footprint within the cost model's
    tolerance?  Symmetric in direction: both a law UNDER-predicting (hides
    an OOM the liveness analysis would have caught) and OVER-predicting
    (peak-HBM lints fire spuriously) count as drift."""
    if predicted_bytes <= 0 or measured_bytes <= 0:
        return predicted_bytes == measured_bytes
    ratio = measured_bytes / predicted_bytes
    return (1.0 / factor) <= ratio <= factor


# ---------------------------------------------------------------------------
# Ingestion laws: peak HOST memory of the streaming loaders (paper §4.2.2).
#
# The paper's creation routines build a ds-array one block-row at a time so
# no process holds the full matrix; the streaming loaders in ``core.io``
# realize that bound and these laws predict it.  ``benchmarks/bench_io.py``
# measures both sides with tracemalloc and records the ratio, and the
# ``tests/test_io.py`` acceptance asserts the streamed peak stays under
# ``INGEST_PEAK_FACTOR`` block-rows.
# ---------------------------------------------------------------------------


#: streamed-load acceptance bound, in units of one block-row's bytes: the
#: block-row buffer + the transient host copy the device transfer makes +
#: one raw chunk and its parsed slab.
INGEST_PEAK_FACTOR = 3.0


def ingest_blockrow_bytes(gm: int, bn: int, bm: int, e: int) -> float:
    """Host bytes of one assembled dense block row (the streaming unit)."""
    return float(gm) * bn * bm * e


def ingest_txt_file_bytes(n: int, m: int, chars_per_value: int = 8) -> float:
    """On-disk bytes of an (n, m) delimited text file — each value costs
    its digits plus one separator, the text-inflation the one-shot parser
    must additionally hold as pages."""
    return float(n) * m * (chars_per_value + 1)


def ingest_peak_host_bytes(gn: int, gm: int, bn: int, bm: int, e: int,
                           chunk_bytes: int, streamed: bool = True) -> float:
    """Predicted peak host bytes of a text/npy load.  Streamed: one raw
    chunk + ~2 block-rows (the fill buffer and the transient copy made by
    the host->device transfer).  Materialized: the full parsed (n, m)
    array — ``gn`` block-rows — before blocking even starts."""
    row = ingest_blockrow_bytes(gm, bn, bm, e)
    if streamed:
        return float(chunk_bytes) + 2.0 * row
    return float(gn) * row


def ingest_peak_ratio(gn: int, gm: int, bn: int, bm: int, e: int,
                      chunk_bytes: int) -> float:
    """Materialized/streamed peak-host-memory ratio — the law the
    ``BENCH_io.json`` streamed-vs-materialized measurement should track;
    grows linearly with the number of block rows."""
    return (ingest_peak_host_bytes(gn, gm, bn, bm, e, chunk_bytes, False)
            / ingest_peak_host_bytes(gn, gm, bn, bm, e, chunk_bytes, True))
