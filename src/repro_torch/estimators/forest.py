"""Random forest classifier on ds-arrays, histogram-grown on the stacked
blocks (the port of ``repro.estimators.forest``).

dislib's RandomForestClassifier trains each tree on a bootstrap of the
distributed dataset; the reference replaces per-node row partitioning with
**level-synchronous histogram** growth, and so does the port:

* features are quantized ONCE into ``n_bins`` codes per block row: the code
  of a value is the number of its feature's bin edges below it (the
  reference's ``sum(x > edge)``), edges from the block-native column
  ``min``/``max``;
* every tree level counts (node, feature, bin, class) for one tree at a
  time with an **integer** ``index_add_`` over the rows' keys, weighted by
  the bootstrap multiplicities.  The reference contracts a one-hot einsum in
  float32; the counts are integers either way (exact in float32 below
  2²⁴), so they equal its counts, with O(n·m) memory instead of its
  ``n_bins``-fold one-hot;
* splits maximize the Gini-impurity decrease from the cumulative
  histograms: the class sums of squares are exact integers, turned into
  float32 where the reference forms them, so the gains — and the chosen
  splits — equal the reference's wherever its float32 sums are exact, and
  are the same on every device;
* ``predict`` is one ``apply_along_axis`` over the rows of the quantized
  blocks, a fixed-depth walk of every tree and a majority vote per row.

Bootstrap multiplicities are drawn with the reference's NumPy
``SeedSequence([seed, tree, block_row])``, so both packages grow the same
trees.  Sparse inputs densify on entry, by the reference's policy
(quantization bins every position).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.blocking import BlockGrid
from repro_torch.core.dsarray import _NARROW, PAD_DIRTY, DsArray, \
    apply_along_axis
from repro_torch.estimators.base import BaseClassifier, _host

# rows of keys per histogram pass (bounds the pass's added memory)
_HIST_ROWS = 1 << 18


def _quantize(x: DsArray, edges: torch.Tensor) -> torch.Tensor:
    """Bin codes ``(gn·bn, m)`` of every row of the zero-padded blocks: for
    each value, the number of its feature's (sorted) edges strictly below
    it, one block row at a time."""
    gn, gm, bn, bm = x.blocks.shape
    m = x.shape[1]
    dtype = torch.uint8 if edges.shape[1] < 256 else torch.int32
    out = torch.empty((gn * bn, m), dtype=dtype, device=x.device)
    for g in range(gn):
        rows = x.blocks[g].permute(1, 0, 2).reshape(bn, gm * bm)[:, :m]
        codes = torch.searchsorted(edges, rows.T.contiguous(), side="left")
        out[g * bn:(g + 1) * bn] = codes.T.to(dtype)
    return out


def _histogram(fkey: torch.Tensor, rowkey: torch.Tensor, w: torch.Tensor,
               n_keys: int) -> torch.Tensor:
    """Integer counts ``(n_keys,)``: every (row, feature) adds its row's
    weight at ``rowkey[row] + fkey[row, feature]``."""
    counts = torch.zeros(n_keys, dtype=torch.int32, device=fkey.device)
    m = fkey.shape[1]
    for lo in range(0, fkey.shape[0], _HIST_ROWS):
        keys = rowkey[lo:lo + _HIST_ROWS, None] + fkey[lo:lo + _HIST_ROWS]
        wts = w[lo:lo + _HIST_ROWS, None].expand(-1, m)
        counts.index_add_(0, keys.reshape(-1), wts.reshape(-1))
    return counts


def _best_splits(counts: torch.Tensor, n_bins: int):
    """Per (tree, node): the (feature, bin) split maximizing the Gini
    decrease, from the cumulative integer histogram ``(t, N, f, B, C)``.
    Returns (feat, bin) int32; nodes with no positive gain get the
    sentinel bin ``n_bins`` (every sample routes left: a leaf)."""
    f32 = lambda v: v.to(torch.float32)             # noqa: E731
    left = torch.cumsum(counts.to(torch.int64), dim=3)
    total = left[:, :, :, -1:, :]
    right = total - left
    nl, nr, nt = left.sum(-1), right.sum(-1), total.sum(-1)
    gl = f32(nl) - f32((left * left).sum(-1)) / torch.clamp(f32(nl), min=1.0)
    gr = f32(nr) - f32((right * right).sum(-1)) / torch.clamp(f32(nr), min=1.0)
    gp = f32(nt) - f32((total * total).sum(-1)) / torch.clamp(f32(nt), min=1.0)
    gain = gp - gl - gr                              # (t, N, f, B)
    # a split must send something BOTH ways; bin B-1 sends all left
    gain = torch.where((nl > 0) & (nr > 0), gain, -torch.inf)
    t, n_nodes, m, b = gain.shape
    flat = gain.reshape(t, n_nodes, m * b)
    best = torch.argmax(flat, dim=-1)
    best_gain = torch.gather(flat, -1, best[..., None])[..., 0]
    feat = best // b
    sbin = torch.where(best_gain > 1e-6, best % b, n_bins)
    return feat.to(torch.int32), sbin.to(torch.int32)


@dataclasses.dataclass
class RandomForestClassifier(BaseClassifier):
    """dislib-style forest: ``RandomForestClassifier(...).fit(x, y)``.

    Trees are complete binary trees of ``max_depth`` levels stored as flat
    heap arrays (``feat_[t, node]`` / ``bin_[t, node]`` per level, the leaf
    class at the bottom), grown level-synchronously from histograms.  The
    fitted arrays are small host NumPy arrays, as the reference's.
    """

    n_estimators: int = 8
    max_depth: int = 6
    n_bins: int = 16
    bootstrap: bool = True
    seed: int = 0

    classes_: Optional[np.ndarray] = None
    edges_: Optional[np.ndarray] = None     # (m, n_bins-1) feature bin edges
    feat_: Optional[np.ndarray] = None      # (t, 2^depth - 1) split features
    bin_: Optional[np.ndarray] = None       # (t, 2^depth - 1) split bins
    leaf_class_: Optional[np.ndarray] = None  # (t, 2^depth) class index
    n_features_in_: int = 0

    # -- fit -----------------------------------------------------------------
    def _bin_edges(self, x: DsArray) -> np.ndarray:
        """Uniform per-feature bin edges between the block-native column
        min/max reductions (paper Fig. 5 column tasks)."""
        lo = _host(x.min(axis=0)).astype(np.float32).ravel()
        hi = _host(x.max(axis=0)).astype(np.float32).ravel()
        span = np.where(hi > lo, hi - lo, 1.0)
        steps = np.arange(1, self.n_bins, dtype=np.float32) / self.n_bins
        return (lo[:, None] + span[:, None] * steps[None, :]).astype(np.float32)

    def _bootstrap_weights(self, gn: int, bn: int, n: int,
                           t: int) -> np.ndarray:
        """(t, gn, bn) sample multiplicities: each (tree, block-row) draws
        its own bootstrap of the block's valid rows from one fold of the
        seeded generator (the reference's draws, bit for bit)."""
        w = np.zeros((t, gn, bn), np.float32)
        for ti in range(t):
            for g in range(gn):
                rows = min(bn, n - g * bn)
                if rows <= 0:
                    continue
                rng = np.random.default_rng(
                    np.random.SeedSequence([self.seed, ti, g]))
                if self.bootstrap:
                    w[ti, g, :rows] = np.bincount(
                        rng.integers(0, rows, size=rows), minlength=rows)[:rows]
                else:
                    w[ti, g, :rows] = 1.0
        return w

    def fit(self, x, y) -> "RandomForestClassifier":
        with self._driver_scope():
            return self._fit(x, y)

    def _fit(self, x, y) -> "RandomForestClassifier":
        x, y_raw = self._validate_fit(x, y)
        if x.is_sparse:
            x = x.todense()          # quantization bins every position
        x = x.ensure_zero_pad()
        yi = self._encode_labels(y_raw)
        n, m = x.shape
        c = len(self.classes_)
        t, depth, nb = self.n_estimators, self.max_depth, self.n_bins
        dev = x.device
        self.n_features_in_ = m
        self.edges_ = self._bin_edges(x)

        gn, _, bn, _ = x.blocks.shape
        codes = _quantize(x, torch.as_tensor(self.edges_, device=dev))
        rows = gn * bn
        per_node = m * nb * c                 # keys of one node
        kdt = torch.int32 if (per_node << depth) < 2 ** 31 else torch.int64
        # (feature, bin) part of every key: (f·B + code)·C
        fkey = (torch.arange(m, dtype=kdt, device=dev) * nb + codes.to(kdt)) * c
        w = torch.as_tensor(self._bootstrap_weights(gn, bn, n, t),
                            device=dev).to(torch.int32).reshape(t, rows)
        y_pad = torch.zeros(rows, dtype=kdt, device=dev)
        y_pad[:n] = torch.as_tensor(yi, device=dev).to(kdt)

        node = torch.zeros((t, rows), dtype=torch.int64, device=dev)
        feats, bins = [], []
        for level in range(depth):
            n_nodes = 1 << level
            counts = torch.stack([
                _histogram(fkey, node[ti].to(kdt) * per_node + y_pad, w[ti],
                           n_nodes * per_node)
                for ti in range(t)]).reshape(t, n_nodes, m, nb, c)
            feat, sbin = _best_splits(counts, nb)          # (t, 2^level)
            del counts
            feats.append(feat.cpu().numpy())
            bins.append(sbin.cpu().numpy())
            # route: node' = 2*node + (code[sample, feat(node)] > bin(node))
            f_sel = torch.gather(feat.to(torch.int64), 1, node)
            b_sel = torch.gather(sbin, 1, node)
            code_sel = torch.gather(codes.expand(t, rows, m), 2,
                                    f_sel[..., None])[..., 0]
            node = 2 * node + (code_sel > b_sel)
        del fkey
        # leaves: class counts per (tree, leaf); empty leaves inherit the
        # global class distribution, so they never predict an unseen class
        leaf_counts = torch.stack([
            torch.zeros((1 << depth) * c, dtype=torch.int32, device=dev)
            .index_add_(0, node[ti] * c + y_pad, w[ti])
            for ti in range(t)]).reshape(t, 1 << depth, c)
        prior = torch.as_tensor(np.bincount(yi, minlength=c), device=dev) \
            .to(torch.float32) * 1e-6
        self.leaf_class_ = torch.argmax(
            leaf_counts.to(torch.float32) + prior, dim=-1) \
            .to(torch.int32).cpu().numpy()
        self.feat_ = np.concatenate(feats, axis=1)     # heap order per level
        self.bin_ = np.concatenate(bins, axis=1)
        return self

    # -- predict -------------------------------------------------------------
    def predict(self, x) -> DsArray:
        """Majority vote of all trees: the rows are quantized per block row,
        then ONE ``apply_along_axis`` over them walks every tree and counts
        the votes per row — no ``collect()`` of the data."""
        self._check_fitted("feat_")
        with self._driver_scope():
            return self._predict(x)

    def _predict(self, x) -> DsArray:
        x = self._validate_x(x)
        if x.is_sparse:
            x = x.todense()
        x = x.ensure_zero_pad()
        dev = x.device
        t, depth = self.n_estimators, self.max_depth
        n, m = x.shape
        gn, _, bn, _ = x.blocks.shape
        codes = _quantize(x, torch.as_tensor(self.edges_, device=dev))
        codes_ds = DsArray(codes.reshape(gn, 1, bn, m), BlockGrid((n, m), (bn, m)),
                           PAD_DIRTY)
        feat = torch.as_tensor(self.feat_, device=dev).to(torch.int64)
        sbin = torch.as_tensor(self.bin_, device=dev)
        leaf = torch.as_tensor(self.leaf_class_, device=dev).to(torch.int64)
        classes = torch.as_tensor(self.classes_, device=dev)
        classes = classes.to(_NARROW.get(classes.dtype, classes.dtype))
        level_base = torch.as_tensor(
            np.cumsum([0] + [1 << d for d in range(depth - 1)]), device=dev)
        trees = torch.arange(t, device=dev)

        def row_vote(row):
            nd = torch.zeros(t, dtype=torch.int64, device=dev)
            for d in range(depth):
                idx = level_base[d] + nd                    # (t,)
                go_right = row[feat[trees, idx]] > sbin[trees, idx]
                nd = 2 * nd + go_right.to(torch.int64)
            # the most voted class, the smallest on a tie: count each vote's
            # repeats among the sorted votes (t x t, not t x classes)
            votes = torch.sort(leaf[trees, nd]).values      # (t,)
            repeats = (votes[:, None] == votes[None, :]).sum(1, dtype=torch.int32)
            return classes[votes[torch.argmax(repeats)]]

        return apply_along_axis(row_vote, 1, codes_ds)      # (n, 1)
