"""Sequence metrics, computed on the host in numpy (the JAX package's, copied).

``batch_acc`` is the reference metric: pad the shorter of pred/target with PAD
to equal length, build the union mask of non-pad positions, per-row token
accuracy over that mask, mean over the batch. ``exact_match_rate`` is the
stricter metric (every non-pad token equal). ``edit_similarity`` is
alignment-robust: 1 - Levenshtein / max length, per row.

They run on token ids already on the host: pass numpy arrays or CPU tensors
(a CUDA tensor must be copied with ``.cpu()`` first).
"""

from __future__ import annotations

import numpy as np


def _pad_to_common(pred, target, pad_token: int):
    pred = np.asarray(pred)
    target = np.asarray(target)
    lp, lt = pred.shape[1], target.shape[1]
    if lp < lt:
        pred = np.pad(pred, ((0, 0), (0, lt - lp)), constant_values=pad_token)
    elif lt < lp:
        target = np.pad(target, ((0, 0), (0, lp - lt)), constant_values=pad_token)
    return pred, target


def batch_acc(pred, target, pad_token: int) -> float:
    """Mean per-row token accuracy over the union non-pad mask."""
    pred, target = _pad_to_common(pred, target, pad_token)
    mask = (pred != pad_token) | (target != pad_token)
    seq_lens = np.maximum(mask.sum(axis=1), 1)
    correct = ((pred == target) & mask).sum(axis=1)
    return float(np.mean(correct.astype(np.float32) / seq_lens.astype(np.float32)))


def exact_match_rate(pred, target, pad_token: int) -> float:
    """Fraction of rows whose entire union-masked token sequence matches."""
    pred, target = _pad_to_common(pred, target, pad_token)
    mask = (pred != pad_token) | (target != pad_token)
    row_ok = np.all((pred == target) | ~mask, axis=1)
    return float(np.mean(row_ok.astype(np.float32)))


def edit_similarity(pred, target, pad_token: int) -> float:
    """Mean normalized edit similarity: 1 - levenshtein(pred_row, target_row)
    / max(len_pred, len_target), averaged over rows (host-side numpy; runs on
    already-decoded id sequences, not on device).

    batch_acc is position-aligned, so one inserted or dropped token zeroes
    the rest of a long row; edit similarity is not. Not a reference metric;
    reported alongside, never instead.
    """
    pred = np.asarray(pred)
    target = np.asarray(target)
    sims = []
    for p_row, t_row in zip(pred, target):
        p = p_row[p_row != pad_token].astype(np.int64)
        t = t_row[t_row != pad_token].astype(np.int64)
        if not len(p) and not len(t):
            sims.append(1.0)
            continue
        if len(p) and t.shape == p.shape and (p == t).all():
            sims.append(1.0)
            continue
        # Two-row Levenshtein DP with the inner loop vectorized: the
        # deletion/substitution candidates are elementwise in prev; the
        # insertion closure cur[j] = min_{k<=j}(cand[k] + (j - k)) is a
        # running min of (cand - arange) plus arange.
        m = len(t)
        ar = np.arange(m + 1)
        prev = ar.copy()
        for i, a in enumerate(p, 1):
            cand = np.empty(m + 1, np.int64)
            cand[0] = i
            cand[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (t != a))
            prev = np.minimum.accumulate(cand - ar) + ar
        sims.append(1.0 - prev[-1] / max(len(p), len(t)))
    return float(np.mean(sims)) if sims else 0.0
