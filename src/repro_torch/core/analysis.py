"""Analytical waste model — paper Eqs. (1)-(4).

Eq. (1)  KV memory of a batch:  2·L·H·D·S_max·B·N
Eq. (2)  waste ratio:           (S_max - S_avg) / S_max
Eq. (3)  expected waste:        Σ_b ∫_{L_b}^{U_b} (1 - S/U_b) f(S) dS
Eq. (4)  optimal boundary:      U_b* = E[S | S in bucket]

These drive both the benchmark `waste_model` (validating that midpoint
bisection approaches the Eq.-(4) optimum) and the beyond-paper
quantile-based boundary refinement (core/bucket.py).
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def kv_cache_bytes(n_layers: int, n_heads: int, d_head: int, s_max: int,
                   bytes_per_el: int, batch: int) -> int:
    """Paper Eq. (1)."""
    return 2 * n_layers * n_heads * d_head * s_max * bytes_per_el * batch


def waste_ratio(lengths: Sequence[int]) -> float:
    """Paper Eq. (2) for one batch."""
    if len(lengths) == 0:
        return 0.0
    smax = max(lengths)
    if smax == 0:
        return 0.0
    return (smax - float(np.mean(lengths))) / smax


def expected_waste(lengths: np.ndarray, boundaries: Sequence[float]) -> float:
    """Paper Eq. (3), empirical: lengths ~ f(S); buckets [b_i, b_{i+1}).

    Padding target of bucket b is its upper bound U_b; waste of a request
    of length S is (1 - S/U_b).  Returns the mean over all requests.
    """
    lengths = np.asarray(lengths, np.float64)
    bounds = np.asarray(sorted(boundaries), np.float64)
    assert len(bounds) >= 2
    idx = np.clip(np.searchsorted(bounds, lengths, side="right") - 1,
                  0, len(bounds) - 2)
    ub = bounds[idx + 1]
    ub = np.maximum(ub, 1e-9)
    return float(np.mean(1.0 - np.minimum(lengths, ub) / ub))


def padded_tokens(lengths: np.ndarray, boundaries: Sequence[float]) -> float:
    """Total padded-slot tokens under bucket-upper padding (for benches)."""
    lengths = np.asarray(lengths, np.float64)
    bounds = np.asarray(sorted(boundaries), np.float64)
    idx = np.clip(np.searchsorted(bounds, lengths, side="right") - 1,
                  0, len(bounds) - 2)
    return float(np.sum(bounds[idx + 1] - lengths))


def optimal_boundary(lengths: np.ndarray, low: float, up: float) -> float:
    """Paper Eq. (4): conditional expectation of S within [low, up)."""
    lengths = np.asarray(lengths, np.float64)
    sel = lengths[(lengths >= low) & (lengths < up)]
    if sel.size == 0:
        return (low + up) / 2
    return float(sel.mean())


def optimal_boundaries_kmeans(lengths: np.ndarray, k: int,
                              iters: int = 50) -> list[float]:
    """Iterate Eq. (4) to a fixed point (1-D Lloyd's) — the paper's
    theoretical optimum, used as the gold standard in benchmarks and by
    the beyond-paper `distribution_aware` refinement."""
    lengths = np.sort(np.asarray(lengths, np.float64))
    if lengths.size == 0:
        return [0.0, 1.0]
    qs = np.linspace(0, 1, k + 1)
    bounds = np.quantile(lengths, qs)
    bounds[0], bounds[-1] = 0.0, lengths[-1] + 1
    for _ in range(iters):
        centers = []
        for i in range(k):
            centers.append(optimal_boundary(lengths, bounds[i], bounds[i + 1]))
        new = bounds.copy()
        for i in range(k - 1):
            # boundary between buckets i, i+1 sits between their optima
            new[i + 1] = (centers[i] + centers[i + 1]) / 2
        if np.allclose(new, bounds):
            break
        bounds = new
    return list(bounds)
