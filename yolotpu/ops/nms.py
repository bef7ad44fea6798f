"""On-device class-wise NMS with fixed shapes.

The reference suppresses on the CPU after reading back the whole region
tensor (``src/core/yolo_post.cpp:54-85``). Here the decode + suppression
run inside the jitted program and only a fixed-size top-K table leaves the
device — per frame a few KB instead of the 287 KB head tensor.

Darknet semantics preserved (class-wise greedy NMS): for each class, boxes
sorted by prob; a box's class-prob is zeroed when a higher-scoring surviving
box of the same class overlaps it with IoU > thresh. The greedy chain is an
O(K^2) masked scan over score-sorted boxes — fixed shapes, no data-dependent
control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def box_iou_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(N,4) x (M,4) center-format IoU."""
    ax0, ay0 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax1, ay1 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx0, by0 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx1, by1 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    iw = jnp.maximum(0.0, jnp.minimum(ax1[:, None], bx1[None, :])
                     - jnp.maximum(ax0[:, None], bx0[None, :]))
    ih = jnp.maximum(0.0, jnp.minimum(ay1[:, None], by1[None, :])
                     - jnp.maximum(ay0[:, None], by0[None, :]))
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None, :] - inter
    return inter / jnp.maximum(union, 1e-12)


def greedy_nms_mask(ious: jnp.ndarray, scores: jnp.ndarray,
                    thresh: float) -> jnp.ndarray:
    """Survivor mask for greedy NMS over one class.

    ious: (K,K) IoU of score-DESC-sorted boxes; scores: (K,) sorted desc
    (zeros = absent). Returns keep mask (K,) — a box survives unless a
    surviving earlier (higher-scored) box overlaps it > thresh.
    """
    K = scores.shape[0]
    sup = (ious > thresh)

    def body(keep, i):
        # box i is suppressed if any kept j<i suppresses it
        alive = scores[i] > 0
        earlier = jnp.arange(K) < i
        killed = jnp.any(sup[:, i] & keep & earlier)
        keep = keep.at[i].set(alive & ~killed)
        return keep, None

    keep0 = jnp.zeros((K,), bool)
    keep, _ = jax.lax.scan(body, keep0, jnp.arange(K))
    return keep


def topk_decode_nms(boxes: jnp.ndarray, obj: jnp.ndarray, probs: jnp.ndarray,
                    thresh: float, nms_thresh: float, topk: int = 256):
    """Batched on-device selection: darknet threshold rule + class-wise NMS.

    boxes (B,N,4), obj (B,N), probs (B,N,C) — from ops.region.decode_region.
    Returns (sel_boxes (B,K,4), sel_scores (B,K), sel_classes (B,K),
    sel_valid (B,K), saturated (B,)). Scores follow darknet: prob = obj * p,
    zeroed unless > thresh (yolo_region.cpp:187-191), then class-wise NMS
    over the top-K objectness candidates.

    The host path considers all h*w*n candidates (845 for yolov2-416);
    ``saturated[b]`` is True when frame b had MORE than K above-threshold
    candidates, i.e. the device result may differ from the host path —
    callers can detect truncation instead of silently diverging.
    """

    def per_image(boxes, obj, probs):
        N, C = probs.shape
        k = min(topk, N)
        # candidate set: top-K by objectness (darknet allocates all N,
        # but boxes with obj<=thresh never produce output)
        obj_gated = jnp.where(obj > thresh, obj, 0.0)
        saturated = jnp.sum((obj_gated > 0).astype(jnp.int32)) > k
        top_obj, idx = jax.lax.top_k(obj_gated, k)
        cboxes = boxes[idx]
        cprob = probs[idx] * top_obj[:, None]
        cprob = jnp.where(cprob > thresh, cprob, 0.0)        # (K,C)
        ious = box_iou_matrix(cboxes, cboxes)                # (K,K)

        def one_class(c):
            scores = cprob[:, c]
            order = jnp.argsort(-scores)
            s_sorted = scores[order]
            i_s = ious[order][:, order]
            keep_sorted = greedy_nms_mask(i_s, s_sorted, nms_thresh)
            keep = jnp.zeros_like(keep_sorted).at[order].set(keep_sorted)
            return jnp.where(keep, scores, 0.0)

        cprob_nms = jax.vmap(one_class, out_axes=1)(jnp.arange(C))  # (K,C)
        best_c = jnp.argmax(cprob_nms, axis=1)
        best_p = jnp.take_along_axis(cprob_nms, best_c[:, None], 1)[:, 0]
        valid = best_p > thresh
        # order output by score desc
        o = jnp.argsort(-best_p)
        return (cboxes[o], best_p[o], best_c[o].astype(jnp.int32), valid[o],
                saturated)

    return jax.vmap(per_image)(boxes, obj, probs)
