"""Detection accuracy evaluation: VOC AP / COCO-style mAP.

The reference tracks accuracy only via region-dump parity on dog.jpg
(SURVEY §4.2); the rebuild's accuracy criterion is mAP (int16 within 0.1 of
fp32 — BASELINE.md). This module scores detections against ground truth:

- ``ap_voc``: single-IoU average precision with the continuous (area-under-
  PR-curve, VOC2010+) interpolation,
- ``map_coco``: mean AP over IoU 0.50:0.05:0.95,
- dataset loading in darknet label format (one ``class cx cy w h`` line per
  object, normalized), the format YOLOv2 was trained with.

No dataset ships with the repo (zero egress); tests validate the metric
itself on synthetic boxes, and the evaluator CLI accepts any local dataset.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class GroundTruth:
    boxes: np.ndarray      # (N, 4) center-format, normalized
    classes: np.ndarray    # (N,)


@dataclass
class Prediction:
    boxes: np.ndarray      # (M, 4) center-format, normalized
    classes: np.ndarray    # (M,)
    scores: np.ndarray     # (M,)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) center-format IoU matrix."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    ax0, ay0 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax1, ay1 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx0, by0 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx1, by1 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    iw = np.maximum(0, np.minimum(ax1[:, None], bx1) - np.maximum(ax0[:, None], bx0))
    ih = np.maximum(0, np.minimum(ay1[:, None], by1) - np.maximum(ay0[:, None], by0))
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + b[:, 2] * b[:, 3] - inter
    return (inter / np.maximum(union, 1e-12)).astype(np.float32)


def ap_voc(preds: list[Prediction], gts: list[GroundTruth],
           num_classes: int, iou_thresh: float = 0.5) -> dict:
    """Per-class AP + mAP at one IoU threshold (VOC2010+ integration)."""
    aps = {}
    for c in range(num_classes):
        scores, matches = [], []
        n_gt = 0
        for p, g in zip(preds, gts):
            gmask = g.classes == c
            gboxes = g.boxes[gmask]
            n_gt += gboxes.shape[0]
            pmask = p.classes == c
            pboxes, pscores = p.boxes[pmask], p.scores[pmask]
            order = np.argsort(-pscores)
            pboxes, pscores = pboxes[order], pscores[order]
            taken = np.zeros(gboxes.shape[0], bool)
            ious = iou_matrix(pboxes, gboxes)
            for i in range(pboxes.shape[0]):
                scores.append(pscores[i])
                if gboxes.shape[0]:
                    j = int(np.argmax(np.where(taken, -1.0, ious[i])))
                    if not taken[j] and ious[i, j] >= iou_thresh:
                        taken[j] = True
                        matches.append(1)
                        continue
                matches.append(0)
        if n_gt == 0:
            continue
        if not scores:
            aps[c] = 0.0
            continue
        order = np.argsort(-np.asarray(scores))
        m = np.asarray(matches)[order]
        tp = np.cumsum(m)
        fp = np.cumsum(1 - m)
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1)
        # monotone precision envelope, integrate over recall
        for i in range(precision.size - 2, -1, -1):
            precision[i] = max(precision[i], precision[i + 1])
        r = np.concatenate([[0.0], recall, [recall[-1] if recall.size else 0.0]])
        p = np.concatenate([[precision[0] if precision.size else 0.0],
                            precision, [0.0]])
        aps[c] = float(np.sum((r[1:] - r[:-1]) * p[1:]))
    mean = float(np.mean(list(aps.values()))) if aps else 0.0
    return {"per_class": aps, "mAP": mean, "iou": iou_thresh}


def map_coco(preds: list[Prediction], gts: list[GroundTruth],
             num_classes: int) -> dict:
    """COCO-style mAP@[.50:.05:.95] (by the same greedy matcher)."""
    vals = []
    per = {}
    for t in np.arange(0.5, 1.0, 0.05):
        r = ap_voc(preds, gts, num_classes, float(round(t, 2)))
        per[round(float(t), 2)] = r["mAP"]
        vals.append(r["mAP"])
    return {"mAP_50_95": float(np.mean(vals)), "mAP_50": per[0.5],
            "per_iou": per}


# ---------------------------------------------------------------------------
# darknet-format dataset IO
# ---------------------------------------------------------------------------

def load_darknet_labels(label_path: str) -> GroundTruth:
    """One 'class cx cy w h' line per object (normalized center format)."""
    boxes, classes = [], []
    if os.path.exists(label_path):
        for line in open(label_path):
            parts = line.split()
            if len(parts) >= 5:
                classes.append(int(parts[0]))
                boxes.append([float(v) for v in parts[1:5]])
    return GroundTruth(boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                       classes=np.asarray(classes, np.int32))


def detections_to_prediction(dets, thresh: float = 0.0) -> Prediction:
    """yolotpu postprocess Detections -> Prediction (best class per box)."""
    boxes, classes, scores = [], [], []
    for d in dets:
        j, p = d.best_class()
        if p > thresh:
            boxes.append(d.bbox)
            classes.append(j)
            scores.append(p)
    return Prediction(boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                      classes=np.asarray(classes, np.int32),
                      scores=np.asarray(scores, np.float32))


def evaluate_engine(engine, image_label_pairs: list[tuple[str, str]],
                    num_classes: int, thresh: float = 0.005,
                    nms: float = 0.45) -> dict:
    """Run an Engine over (image, label) files and score mAP."""
    from .image import load_image
    preds, gts = [], []
    for img_path, label_path in image_label_pairs:
        im = load_image(img_path)
        dets, _ = engine.detect(im, thresh=thresh, nms=nms)
        preds.append(detections_to_prediction(dets))
        gts.append(load_darknet_labels(label_path))
    out = map_coco(preds, gts, num_classes)
    out["images"] = len(preds)
    return out


def evaluate_engine_batched(engine, image_label_pairs: list[tuple[str, str]],
                            num_classes: int, thresh: float = 0.005,
                            nms: float = 0.45, batch: int = 16) -> dict:
    """Batched-device variant of ``evaluate_engine`` for NET-SIZED images.

    ``evaluate_engine`` pays one host->device roundtrip per image (8 MB of
    fp32 pixels at 416²). When every image is already net-sized (the
    protocol eval sets are rendered at net size), letterbox
    is the identity, so frames batch through ``predict_batch_rgb`` as uint8
    NHWC (4x smaller transfer, one dispatch per ``batch`` images) and only
    the postprocess stays per-image. Numerically identical to the unbatched
    path: the device /255 normalization matches host ``load_image``.
    """
    from .image import load_rgb
    from .postprocess import (do_nms_sort, forward_region,
                              get_region_detections)
    net_w, net_h = engine.spec.net.width, engine.spec.net.height
    frames, gts = [], []
    for img_path, label_path in image_label_pairs:
        arr = load_rgb(img_path)
        if arr.shape[:2] != (net_h, net_w):
            raise ValueError(
                f"evaluate_engine_batched needs net-sized images; "
                f"{img_path} is {arr.shape[:2]}, net is {(net_h, net_w)}")
        frames.append(arr)
        gts.append(load_darknet_labels(label_path))
    preds = []
    rspec = engine.spec.region
    for i in range(0, len(frames), batch):
        chunk = np.stack(frames[i:i + batch])
        heads = engine.predict_batch_rgb(chunk)          # (N, oc, h, w)
        for head in heads:
            act = forward_region(head.reshape(-1), rspec)
            dets = get_region_detections(act, rspec, im_w=net_w, im_h=net_h,
                                         net_w=net_w, net_h=net_h,
                                         thresh=thresh)
            dets = do_nms_sort(dets, rspec.classes, nms)
            preds.append(detections_to_prediction(dets))
    out = map_coco(preds, gts, num_classes)
    out["images"] = len(preds)
    return out
