"""Evaluation metrics: per-class AP / AUC, accuracy, d-prime.

A copy of ``aum_tpu/train/metrics.py`` (numpy only; the port imports nothing
of the JAX package). It re-implements the reference's ``calculate_stats``
(``src/utilities/stats.py:11-60``), which uses sklearn's
average_precision_score / roc_auc_score per class plus top-1 accuracy and
d_prime(auc) = sqrt(2) * ppf(auc). sklearn is used when it is installed
(bit-identical to the reference); otherwise a pure-numpy fallback implements
the same definitions.
"""

from __future__ import annotations

import math

import numpy as np

try:  # pragma: no cover - environment probe
    from sklearn import metrics as _skm
except Exception:  # pragma: no cover
    _skm = None

try:
    from scipy import stats as _scipy_stats
except Exception:  # pragma: no cover
    _scipy_stats = None


def _average_precision_np(y_true, y_score):
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order]
    tp = np.cumsum(y)
    precision = tp / np.arange(1, len(y) + 1)
    n_pos = y.sum()
    if n_pos == 0:
        return np.nan
    return float((precision * y).sum() / n_pos)


def _roc_auc_np(y_true, y_score):
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return np.nan
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks for ties
    i = 0
    r = np.arange(1, len(y_score) + 1, dtype=np.float64)
    while i < len(y_score):
        j = i
        while j + 1 < len(y_score) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        r[i: j + 1] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    ranks[order] = r
    auc = (ranks[y_true > 0.5].sum() - n_pos * (n_pos + 1) / 2) / (
        n_pos * n_neg)
    return float(auc)


def d_prime(auc: float) -> float:
    """stats.py:6-9."""
    if _scipy_stats is not None:
        return float(_scipy_stats.norm().ppf(auc) * math.sqrt(2.0))
    # Acklam's inverse-normal approximation fallback.
    return float(_norm_ppf(auc) * math.sqrt(2.0))


def _norm_ppf(p):
    # Peter Acklam's rational approximation (|rel err| < 1.15e-9).
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return ((((((c[0]*q+c[1])*q+c[2])*q+c[3])*q+c[4])*q+c[5]) /
                ((((d[0]*q+d[1])*q+d[2])*q+d[3])*q+1))
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -((((((c[0]*q+c[1])*q+c[2])*q+c[3])*q+c[4])*q+c[5]) /
                 ((((d[0]*q+d[1])*q+d[2])*q+d[3])*q+1))
    q = p - 0.5
    r = q * q
    return ((((((a[0]*r+a[1])*r+a[2])*r+a[3])*r+a[4])*r+a[5])*q /
            (((((b[0]*r+b[1])*r+b[2])*r+b[3])*r+b[4])*r+1))


def calculate_stats(output: np.ndarray, target: np.ndarray,
                    full_curves: bool = False):
    """Per-class AP/AUC + global top-1 accuracy (stats.py:11-60).

    Args:
      output: (N, C) scores (post-sigmoid in the eval path).
      target: (N, C) multi-hot (or one-hot) labels.

    Returns:
      list of C dicts with keys AP, auc, acc (acc replicated per class like
      the reference).
    """
    output = np.asarray(output)
    target = np.asarray(target)
    classes_num = target.shape[-1]

    acc = float(np.mean(
        np.argmax(output, axis=1) == np.argmax(target, axis=1)))

    stats = []
    for k in range(classes_num):
        yt = target[:, k]
        ys = output[:, k]
        if _skm is not None:
            try:
                ap = _skm.average_precision_score(yt, ys, average=None)
            except ValueError:
                ap = np.nan
            try:
                auc = _skm.roc_auc_score(yt, ys, average=None)
            except ValueError:
                auc = np.nan
        else:
            ap = _average_precision_np(yt > 0.5, ys)
            auc = _roc_auc_np(yt > 0.5, ys)
        entry = {"AP": ap, "auc": auc, "acc": acc}
        if full_curves:
            # 1:1000-downsampled PR and ROC curves (stats.py:30-57). The
            # reference always emits them; fall back to the numpy curves
            # when sklearn is absent/degenerate so 'precisions'/'recalls'
            # are guaranteed present (result_eval.csv depends on them).
            pre = rec = fpr = tpr = None
            if _skm is not None:
                try:
                    pre, rec, _ = _skm.precision_recall_curve(yt, ys)
                    fpr, tpr, _ = _skm.roc_curve(yt, ys)
                except Exception:
                    pre = None
            if pre is None:
                pre, rec, fpr, tpr = _pr_roc_curves_np(yt > 0.5, ys)
            entry.update({
                "precisions": pre[0::1000], "recalls": rec[0::1000],
                "fpr": fpr[0::1000], "fnr": (1.0 - tpr)[0::1000]})
        stats.append(entry)
    return stats


def _pr_roc_curves_np(yt: np.ndarray, ys: np.ndarray):
    """Numpy PR + ROC curves over descending score thresholds (sklearn
    fallback; same orientation as precision_recall_curve/roc_curve)."""
    order = np.argsort(-ys, kind="mergesort")
    y = yt[order].astype(np.int64)
    tp = np.cumsum(y)
    fp = np.cumsum(1 - y)
    n_pos = max(int(y.sum()), 1)
    n_neg = max(int((1 - y).sum()), 1)
    precisions = tp / np.maximum(tp + fp, 1)
    recalls = tp / n_pos
    # sklearn appends the (precision=1, recall=0) endpoint and reverses.
    precisions = np.concatenate([precisions[::-1], [1.0]])
    recalls = np.concatenate([recalls[::-1], [0.0]])
    fpr = np.concatenate([[0.0], fp / n_neg])
    tpr = np.concatenate([[0.0], tp / n_pos])
    return precisions, recalls, fpr, tpr


def mean_average_precision(output, target) -> float:
    stats = calculate_stats(output, target)
    aps = [s["AP"] for s in stats if not np.isnan(s["AP"])]
    return float(np.mean(aps)) if aps else float("nan")
