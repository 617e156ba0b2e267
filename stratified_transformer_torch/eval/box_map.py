"""3D axis-aligned box detection AP of the DCF family's evaluation (the
JAX package's ``eval/box_map.py``, copied so that the port imports none of
it).

Re-derivation of ``util/evaluation.py`` (``DetectionMAP`` :15-328): 3D-SIS
style matching — axis-aligned IoU (jaccard) between predicted and GT boxes,
greedy one-prediction-per-GT assignment above an overlap threshold, TP/FP/FN
accumulation, per-evaluation precision/recall, and running means (the
reference's ``evaluate`` appends precision/recall per scene :84-110).
"""

from __future__ import annotations

from typing import List

import numpy as np


def intersect_volume(box_a, box_b):
    """Pairwise intersection volume, boxes ``[x1,y1,z1,x2,y2,z2]``
    (reference ``intersect_area`` :111-127)."""
    a = box_a[:, None, :]
    b = box_b[None, :, :]
    max_xyz = np.minimum(a[:, :, 3:], b[:, :, 3:])
    min_xyz = np.maximum(a[:, :, :3], b[:, :, :3])
    inter = np.clip(max_xyz - min_xyz, 0, None)
    return inter[:, :, 0] * inter[:, :, 1] * inter[:, :, 2]


def box_iou(box_a, box_b):
    """Jaccard IoU matrix ``[n_pred, n_gt]`` (reference :129-152)."""
    if box_a.shape[0] == 0 or box_b.shape[0] == 0:
        return np.zeros((box_a.shape[0], box_b.shape[0]))
    inter = intersect_volume(box_a, box_b)
    vol = lambda b: np.prod(b[:, 3:] - b[:, :3], axis=1)  # noqa: E731
    union = vol(box_a)[:, None] + vol(box_b)[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def match_boxes(iou, overlap_threshold=0.5):
    """Greedy one-prediction-per-GT matching (reference
    ``compute_TP_FP_FN`` :194-240): each prediction claims its best
    still-unclaimed GT above threshold.

    Returns ``(tp_scores, fp_scores, fn)`` — matched-IoU scores per TP/FP
    prediction (the reference ranks predictions by this score for the PR
    curve, ``APAccumulator.ranking`` :362-369) and the missed-GT count.
    """
    iou = iou.copy()
    iou[iou < overlap_threshold] = 0.0
    n_pred, n_gt = iou.shape
    claimed = np.zeros(n_gt, bool)
    tp_scores, fp_scores = [], []
    for i in range(n_pred):
        row = np.where(claimed, 0.0, iou[i]) if n_gt else np.zeros(0)
        j = int(np.argmax(row)) if n_gt else -1
        if n_gt and row[j] > 0:
            claimed[j] = True
            tp_scores.append(float(row[j]))
        else:
            # Reference scores every FP as -1 (compute_TP_FP_FN's
            # max_overlapping stays -1), ranking FPs strictly after TPs.
            fp_scores.append(-1.0)
    fn = n_gt - len(tp_scores)
    return tp_scores, fp_scores, fn


class DetectionMAP:
    """Running detection metrics across scenes (reference :15-110)."""

    def __init__(self, overlap_threshold=0.5):
        self.overlap_threshold = overlap_threshold
        self.precision: List[float] = []
        self.recall: List[float] = []
        self.tp = 0
        self.fp = 0
        self.fn = 0
        self._preds: List[tuple] = []   # (score, is_tp) per prediction

    def evaluate(self, pred_boxes, gt_boxes):
        iou = box_iou(np.asarray(pred_boxes, float).reshape(-1, 6),
                      np.asarray(gt_boxes, float).reshape(-1, 6))
        tps, fps, fn = match_boxes(iou, self.overlap_threshold)
        tp, fp = len(tps), len(fps)
        self.tp += tp
        self.fp += fp
        self.fn += fn
        for s in tps:
            self._preds.append((s, 1.0))
        for s in fps:
            self._preds.append((s, 0.0))
        self.precision.append(tp / max(tp + fp, 1))
        self.recall.append(tp / max(tp + fn, 1))
        return tp, fp, fn

    # ---- ranked PR curve / AP (reference ``APAccumulator`` :330-399,
    # ``compute_precision_recall_`` :255-274, ``compute_ap`` :241-253) ----

    def _ranked(self):
        if not self._preds:
            return np.empty((0, 2))
        p = np.asarray(self._preds)
        return p[np.argsort(-p[:, 0], kind="stable")]

    def precision_recall_at(self, recall_thresh):
        """Walk the score-ranked predictions until recall >= thresh
        (reference ``APAccumulator.precision_recall`` :378-399)."""
        if recall_thresh == 0.0:
            return 0.0, 0.0
        ranked = self._ranked()
        total_gt = self.tp + self.fn
        tp = fp = 0.0
        for _, is_tp in ranked:
            tp += is_tp
            fp += 1.0 - is_tp
            recall = tp / max(float(total_gt), 1e-12)
            if recall >= recall_thresh:
                return tp / (tp + fp), recall
        return 0.0, 1.0

    def pr_curve(self, pr_samples=11, interpolated=True):
        """Interpolated PR curve over ``linspace(0, 1, pr_samples)`` recall
        thresholds (reference :255-274). Returns (precisions, recalls)."""
        precisions, recalls = [], []
        for t in np.linspace(0, 1, pr_samples):
            p, r = self.precision_recall_at(t)
            precisions.append(p)
            recalls.append(r)
        precisions = precisions[::-1]
        recalls = recalls[::-1]
        if interpolated:
            out, last = [], 0.0
            for p in precisions:
                last = max(last, p)
                out.append(last)
            precisions = out
        return precisions, recalls

    def ap(self, pr_samples=11):
        """Average precision = sum p * delta(recall) over the ranked curve
        (reference ``compute_ap`` :241-253)."""
        precisions, recalls = self.pr_curve(pr_samples)
        prev_r = 0.0
        ap = 0.0
        for p, r in zip(precisions[::-1], recalls[::-1]):
            ap += p * (r - prev_r)
            prev_r = r
        return ap

    def summary(self, pr_samples=11):
        return {
            "mean_precision": float(np.mean(self.precision))
            if self.precision else 0.0,
            "mean_recall": float(np.mean(self.recall))
            if self.recall else 0.0,
            "micro_precision": self.tp / max(self.tp + self.fp, 1),
            "micro_recall": self.tp / max(self.tp + self.fn, 1),
            "AP": self.ap(pr_samples),
            "tp": self.tp, "fp": self.fp, "fn": self.fn,
        }
