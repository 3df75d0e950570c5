"""Evaluation metrics: q-error (paper SVII) and classification accuracy.

A pinned copy of ``repro/core/metrics.py`` (numpy only); the tests hold the
two equal.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

EPS = 1e-6


def qerror(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """q(c, c_hat) = max(c/c_hat, c_hat/c) >= 1; 1 is a perfect estimate."""
    c = np.maximum(np.asarray(y_true, dtype=np.float64), EPS)
    ch = np.maximum(np.asarray(y_pred, dtype=np.float64), EPS)
    return np.maximum(c / ch, ch / c)


def qerror_summary(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    q = qerror(y_true, y_pred)
    return {
        "q50": float(np.median(q)),
        "q95": float(np.percentile(q, 95)),
        "q99": float(np.percentile(q, 99)),
        "mean": float(np.mean(q)),
        "n": int(q.size),
    }


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y = np.asarray(y_true).astype(np.int64)
    p = np.asarray(y_pred).astype(np.int64)
    return float(np.mean(y == p))


def balanced_indices(labels: Sequence[int], rng: np.random.Generator) -> np.ndarray:
    """Subsample indices so both binary classes are equally represented
    (the paper balances classification test sets)."""
    labels = np.asarray(labels).astype(np.int64)
    idx0 = np.flatnonzero(labels == 0)
    idx1 = np.flatnonzero(labels == 1)
    n = min(idx0.size, idx1.size)
    if n == 0:
        return np.arange(labels.size)
    sel = np.concatenate([rng.permutation(idx0)[:n], rng.permutation(idx1)[:n]])
    return np.sort(sel)
