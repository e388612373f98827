"""Running meters and the outlier-segmentation confusion metrics.

Counterpart of ``AverageMeter``, ``confusion_matrix``, ``iou_per_class``,
``mean_iou``, ``metrics_from_confusion`` and ``format_metric_table`` in
``deep3dpointclouddenoising_tpu/utils/metrics.py``, with the same
arithmetic in float64 numpy.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class AverageMeter:
    """The last value and the running weighted average."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def confusion_matrix(targets: np.ndarray, preds: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) counts, rows the targets, columns the
    predictions."""
    idx = targets.astype(np.int64) * num_classes + preds.astype(np.int64)
    return np.bincount(idx, minlength=num_classes ** 2).reshape(
        num_classes, num_classes)


def iou_per_class(conf: np.ndarray):
    """``(iou, existing)``: each class's IoU (1e-8 added) and whether the
    class occurs in the targets or the predictions."""
    tp = np.diag(conf).astype(np.float64)
    fp = conf.sum(axis=0) - tp
    fn = conf.sum(axis=1) - tp
    union = tp + fp + fn
    iou = 1e-8 + tp / (union + 1e-8)
    return iou, union > 1e-3


def mean_iou(conf: np.ndarray, missing_as_one: bool = False) -> float:
    """The mean IoU over the classes that occur (0 when none does); with
    ``missing_as_one`` the others count as 1."""
    values, existing = iou_per_class(conf)
    if existing.sum() == 0:
        return 0.0
    if missing_as_one:
        values = values.copy()
        values[~existing] = 1.0
        existing = np.ones_like(existing)
    return float(values[existing].sum() / existing.sum())


def metrics_from_confusion(conf: np.ndarray,
                           beta: float = np.sqrt(0.3)) -> Dict[str, float]:
    """The binary metric dict in percent from the 2x2 ``[[tn, fp], [fn,
    tp]]`` confusion of the outlier class: mean IoU, precision, recall,
    F-beta (beta^2 = 0.3), accuracy, false-discovery and false-omission
    rates, and the four counts.  With no predicted outlier the precision
    is 0 and the false-discovery rate 1; with no true outlier the recall
    is 0; with no predicted inlier the false-omission rate is 1."""
    tn, fp, fn, tp = conf.ravel().astype(np.float64)
    miou = mean_iou(conf)
    prec = 1e-8 + tp / (tp + fp + 1e-8)
    rec = 1e-8 + tp / (tp + fn + 1e-8)
    macc = (tp + tn) / max(tp + fp + tn + fn, 1e-8)
    fdrate = 1e-8 + fp / (tp + fp + 1e-8)
    forate = 1e-8 + fn / (tn + fn + 1e-8)
    if tp + fp == 0:
        prec, fdrate = 0.0, 1.0
    if tp + fn == 0:
        rec = 0.0
    if tn + fn == 0:
        forate = 1.0
    f_b = ((1 + beta ** 2) * prec * rec) / max(beta ** 2 * prec + rec, 1e-7)
    return {"macc": 100 * macc, "miou": 100 * miou, "prec": 100 * prec,
            "rec": 100 * rec, "fdrate": 100 * fdrate, "forate": 100 * forate,
            "f_b": 100 * f_b, "TN": int(tn), "FP": int(fp), "FN": int(fn),
            "TP": int(tp)}


def format_metric_table(metrics: Dict[str, float], name: str = "") -> str:
    """The metrics but the four counts as a 100-column table."""
    keys = [k for k in metrics if k not in ("TN", "FP", "FN", "TP")]
    cell = int(100 / len(keys))
    sep = "-" * 100
    head = "|".join(f"{k:^{cell}}" for k in keys)
    vals = "|".join(f"{metrics[k]:^{cell}.2f}" for k in keys)
    lines = [sep]
    if name:
        lines.append(f"{name:^100}")
    lines += [head, sep, vals, sep]
    return "\n".join(lines)
