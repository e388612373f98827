"""Running meters, the outlier-segmentation confusion metrics and the
classification and part-segmentation metrics.

Counterpart of ``deep3dpointclouddenoising_tpu/utils/metrics.py``:
``AverageMeter``, ``confusion_matrix``, ``iou_per_class``, ``mean_iou``,
``metrics_from_confusion``, ``format_metric_table``, and (:99-209)
``topk_accuracy``, ``iou_from_confusions``, ``s3dis_metrics``,
``sub_s3dis_metrics``, ``partnet_metrics`` and ``shapenetpart_metrics``,
with the same arithmetic in float64 numpy.
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


def topk_accuracy(logits: np.ndarray, targets: np.ndarray,
                  topk=(1,)):
    """Top-k accuracies for (B, C) logits (util.py:65-80)."""
    order = np.argsort(-logits, axis=1)
    res = []
    for k in topk:
        hit = (order[:, :k] == targets[:, None]).any(axis=1)
        res.append(float(hit.mean()))
    return res


def iou_from_confusions(confusions: np.ndarray) -> np.ndarray:
    """Per-class IoU from stacked confusion matrices [..., C, C]
    (util.py:146-174): absent classes get the present-class mIoU so later
    means are unbiased."""
    confusions = np.asarray(confusions, dtype=np.float64)
    tp = np.diagonal(confusions, axis1=-2, axis2=-1)
    tp_fn = confusions.sum(axis=-1)
    tp_fp = confusions.sum(axis=-2)
    iou = tp / (tp_fp + tp_fn - tp + 1e-6)
    absent = tp_fn < 1e-3
    counts = np.sum(~absent, axis=-1, keepdims=True)
    miou = iou.sum(axis=-1, keepdims=True) / (counts + 1e-6)
    return iou + absent * miou


def s3dis_metrics(num_classes, vote_logits, validation_proj,
                  validation_labels):
    """Full-cloud voting mIoU: logits (C, n_sub) projected per cloud
    (util.py:175-186)."""
    conf = np.zeros((num_classes, num_classes), np.int64)
    for logits, proj, targets in zip(vote_logits, validation_proj,
                                     validation_labels):
        preds = np.argmax(logits[:, proj], axis=0).astype(np.int64)
        conf += confusion_matrix(targets, preds, num_classes)
    ious = iou_from_confusions(conf)
    return ious, float(np.mean(ious))


def sub_s3dis_metrics(num_classes, validation_logits, validation_labels,
                      val_proportions):
    """Subsampled-cloud mIoU rescaled to true class proportions
    (util.py:188-201)."""
    conf = np.zeros((num_classes, num_classes), np.float64)
    for logits, targets in zip(validation_logits, validation_labels):
        preds = np.argmax(logits, axis=0).astype(np.int64)
        conf += confusion_matrix(targets, preds, num_classes)
    conf *= (np.asarray(val_proportions) /
             (conf.sum(axis=1) + 1e-6))[:, None]
    ious = iou_from_confusions(conf)
    return ious, float(np.mean(ious))


def partnet_metrics(num_classes, num_parts, objects, preds, targets):
    """PartNet msIoU / mpIoU (util.py:89-143); preds are (num_parts, N)
    scores per shape, part 0 is 'ignore'."""
    shape_iou_tot = [0.0] * num_classes
    shape_iou_cnt = [0] * num_classes
    part_i = [np.zeros(num_parts[o], np.float64) for o in range(num_classes)]
    part_u = [np.zeros(num_parts[o], np.float64) + 1e-6
              for o in range(num_classes)]
    for obj, pred, gt in zip(objects, preds, targets):
        obj = int(obj)
        cur = np.argmax(pred[1:, :], axis=0) + 1
        cur[gt == 0] = 0
        tot, cnt = 0.0, 0
        for j in range(1, num_parts[obj]):
            gt_m, pr_m = gt == j, cur == j
            if gt_m.any() or pr_m.any():
                inter = np.sum(gt_m & pr_m)
                union = np.sum(gt_m | pr_m)
                tot += inter / union
                cnt += 1
                part_i[obj][j] += inter
                part_u[obj][j] += union
        if cnt:
            shape_iou_tot[obj] += tot / cnt
            shape_iou_cnt[obj] += 1
    ms_iou = [shape_iou_tot[o] / max(shape_iou_cnt[o], 1)
              for o in range(num_classes)]
    mp_iou = [float(np.mean(part_i[o][1:] / part_u[o][1:]))
              for o in range(num_classes)]
    return ms_iou, mp_iou, float(np.mean(ms_iou)), float(np.mean(mp_iou))


def shapenetpart_metrics(num_classes, num_parts, objects, preds, targets,
                         masks):
    """ShapeNet-Part accuracy + class/instance average mIoU
    (util.py:222-268)."""
    total_correct = total_seen = 0.0
    confs, objs = [], np.asarray([int(o) for o in objects])
    for obj, pred, gt, m in zip(objs, preds, targets, masks):
        p = np.argmax(pred, axis=0)[m]
        g = np.asarray(gt)[m]
        total_correct += np.sum(p == g)
        total_seen += len(p)
        confs.append(confusion_matrix(g, p, num_parts[obj]))
    obj_mious = []
    for c in range(num_classes):
        idx = np.nonzero(objs == c)[0]
        if len(idx) == 0:
            obj_mious.append(np.zeros(0))
            continue
        ious = iou_from_confusions(np.stack([confs[i] for i in idx]))
        obj_mious.append(np.mean(ious, axis=-1))
    objs_average = [float(np.mean(m)) if len(m) else 0.0 for m in obj_mious]
    instance_average = float(np.mean(np.hstack(
        [m for m in obj_mious if len(m)])))
    class_average = float(np.mean(objs_average))
    acc = total_correct / max(total_seen, 1.0)
    return acc, objs_average, class_average, instance_average
