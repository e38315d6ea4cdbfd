"""The clustering job's judge and its plain K-means.

``judge`` holds a fit's answers to what they claim, in float64 on the rows
the fit was given: each label the nearest center, the inertia the sum of
the nearest distances, each center the mean of the rows nearest to it
among the centers its last Lloyd iteration started from, the fit stopped
only where its last shift was within ``tol`` or at ``max_iter``, and its
inertia that of a plain float64 Lloyd loop (``lloyd``) run from the same
starting centers with the same ``max_iter`` and ``tol``.  ``fit`` is a
plain K-means (k-means++ by D² sampling, then Lloyd), whose products run
in the precision asked for: the control puts it in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.common import held, precision, prod

ROWS = 8192
#: two distances closer than this share of ‖x‖² + ‖c‖² (16 float32 epsilons
#: of the terms the distance is formed from) are a tie that float32
#: arithmetic cannot order: either center is a sound choice for the row
TIE = 1e-6
#: the most tied rows followed one by one; more are judged as not tied
MAX_TIES = 4096


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest relative distance between two rows: ‖got − want‖ / ‖want‖."""
    worst = 0.0
    for lo in range(0, want.shape[0], ROWS):
        g, w = got[lo:lo + ROWS].double(), want[lo:lo + ROWS].double()
        r = torch.linalg.vector_norm(g - w, dim=1) / torch.linalg.vector_norm(w, dim=1)
        worst = max(worst, float(r.max()))
    return worst


def sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Squared distances (n, k) in float64: ‖x‖² − 2x·cᵀ + ‖c‖²."""
    c = centers.double().to(x.device)
    csq = (c * c).sum(1)
    out = []
    for lo in range(0, x.shape[0], ROWS):
        xx = x[lo:lo + ROWS].double()
        out.append((xx * xx).sum(1)[:, None] - 2 * xx @ c.T + csq[None])
    return torch.cat(out).clamp_(min=0.0)


def step_means(x: torch.Tensor, prev: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """One Lloyd step from ``prev`` in float64: each center the mean of the
    rows nearest to it (an empty cluster keeps its center).  A row whose
    two nearest centers tie (``TIE``) goes to the one of the two that
    brings both means nearer the centers the fit gave, ``got``."""
    xd = x.double()
    p = prev.double().to(x.device)
    d = sq_dists(x, p)
    near = d.topk(2, dim=1, largest=False)
    owner = near.indices[:, 0].clone()
    scale = (xd * xd).sum(1) + (p * p).sum(1)[owner]
    tied = torch.nonzero(near.values[:, 1] - near.values[:, 0] <= TIE * scale)[:, 0]
    k = p.shape[0]
    sums = torch.zeros_like(p).index_add_(0, owner, xd)
    counts = torch.bincount(owner, minlength=k).double()
    if tied.numel() <= MAX_TIES:
        for r in tied.tolist():
            a, b = owner[r].item(), near.indices[r, 1].item()

            def miss(sa, na, sb, nb):
                return sum(float(torch.linalg.vector_norm(s / n - got[c])) if n else 0.0
                           for s, n, c in ((sa, na, a), (sb, nb, b)))
            stay = miss(sums[a], counts[a], sums[b], counts[b])
            move = miss(sums[a] - xd[r], counts[a] - 1, sums[b] + xd[r], counts[b] + 1)
            if move < stay:
                sums[a] -= xd[r]
                sums[b] += xd[r]
                counts[a] -= 1
                counts[b] += 1
    return torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], p)


def lloyd(x: torch.Tensor, init: torch.Tensor, max_iter: int, tol: float) -> dict:
    """Lloyd's iterations in float64 from the centers ``init``: each row to
    its nearest center, each center to the mean of its rows (an empty
    cluster keeps its center), until the centers move by at most ``tol``
    (the norm of the whole move) or ``max_iter`` iterations.  Returns the
    inertia of the last centers and the iterations run."""
    c = init.double().to(x.device)
    it = 0
    for it in range(1, max_iter + 1):
        owner = sq_dists(x, c).argmin(dim=1)
        sums = torch.zeros_like(c).index_add_(0, owner, x.double())
        counts = torch.bincount(owner, minlength=c.shape[0]).double()
        new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], c)
        shift = float(torch.linalg.vector_norm(new - c))
        c = new
        if shift <= tol:
            break
    return {"inertia": float(sq_dists(x, c).min(dim=1).values.sum()), "n_iter": it}


def judge(x: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor,
          inertia: float, prev: torch.Tensor, fit: dict, max_iter: int,
          tol: float) -> dict:
    """The fit's answers against what they claim, in float64: ``label_gap``
    (the widest excess of a row's distance to its labelled center over its
    nearest, over the mean nearest distance), ``center_gap`` (the widest
    distance between a center and the mean of the rows nearest to it among
    ``prev``, the centers the last Lloyd iteration started from, over the
    centers' mean norm: :func:`step_means`),
    ``inertia_gap`` (relative), ``stop_gap`` (the last shift over ``tol``
    where the fit stopped before ``max_iter``, else 0; ``fit`` holds the
    fit's ``init``, ``shift`` and ``n_iter``), ``lloyd_gap`` (the inertia's
    relative gap to :func:`lloyd`'s from ``init``) and ``iter_gap`` (the
    two loops' iterations apart)."""
    d = sq_dists(x, centers)
    labels = labels.to(d.device).long().reshape(-1)
    best = d.min(dim=1).values
    mine = d.gather(1, labels[:, None])[:, 0]
    label_gap = float((mine - best).max() / best.mean())
    total = float(best.sum())
    want = step_means(x, prev, centers.double().to(x.device))
    scale = torch.linalg.vector_norm(want, dim=1).mean()
    center_gap = float(torch.linalg.vector_norm(centers.double().to(x.device) - want,
                                                dim=1).max() / scale)
    plain = lloyd(x, fit["init"], max_iter, tol)
    stopped = fit["n_iter"] < max_iter
    return {"label_gap": label_gap, "center_gap": center_gap,
            "inertia_gap": abs(float(inertia) - total) / total,
            "stop_gap": fit["shift"] / tol if stopped else 0.0,
            "lloyd_gap": abs(float(inertia) - plain["inertia"]) / plain["inertia"],
            "iter_gap": float(abs(fit["n_iter"] - plain["n_iter"]))}


def fit(x: torch.Tensor, k: int, max_iter: int, tol: float, seed: int,
        mode: str = "fp32") -> dict:
    """Plain K-means on the rows x: k-means++ (D² sampling, NumPy draws from
    ``seed``) then Lloyd until the centers move by at most ``tol`` or
    ``max_iter`` iterations, the distances ‖x‖² − 2x·cᵀ + ‖c‖² with their
    products in ``mode`` and the rows as ``mode`` holds them (TF32's
    mantissa under ``"tf32"``).  Returns the answers a fit gives."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    with precision(mode):
        xf = held(x.float())
    xsq = (xf * xf).sum(1)

    def dists(c):
        with precision(mode):
            return xsq[:, None] - 2 * prod("nd,kd->nk", xf, c) + (c * c).sum(1)[None]

    centers = [xf[int(rng.integers(n))]]
    d2 = ((xf - centers[0]) ** 2).sum(1)
    for _ in range(1, k):
        p = np.maximum(d2.double().cpu().numpy(), 0.0)
        centers.append(xf[int(rng.choice(n, p=p / p.sum()))])
        d2 = torch.minimum(d2, ((xf - centers[-1]) ** 2).sum(1))
    c = init = torch.stack(centers)
    prev, shift, it = c, 0.0, 0
    for it in range(1, max_iter + 1):
        prev = c
        labels = dists(c).argmin(1)
        sums = torch.zeros_like(c).index_add_(0, labels, xf)
        counts = torch.bincount(labels, minlength=k).float()
        new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], c)
        shift = float(torch.linalg.vector_norm(new - c))
        c = new
        if shift <= tol:
            break
    d = dists(c)
    return {"centers": c, "labels": d.argmin(1), "prev": prev,
            "inertia": float(d.min(1).values.double().sum()),
            "init": init, "shift": shift, "n_iter": it}
