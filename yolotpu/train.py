"""YOLOv2 training: region loss + SGD step, mesh-shardable.

The reference stack is inference-only (SURVEY §0); training exists here
because a complete framework must regenerate its own weight artifacts
(the reference outsources that to the external ``nn-weight-extractor``
repo, ``weights/README.md:33-59``). The loss follows darknet's region-layer
training semantics in fixed-shape, fully-vectorized form:

- predictions decode as in ``get_region_box`` (yolo_region.cpp:18-26),
- every anchor predicts objectness toward 0 scaled by ``noobject_scale``
  unless its best IoU against any truth exceeds ``thresh``,
- each truth box is assigned the anchor (in its cell) with best shape IoU;
  that anchor gets coordinate deltas in (tx, ty, tw, th) space, objectness
  toward IoU (rescore) and class cross-entropy,
- truths are padded to ``max_boxes`` with a validity mask (darknet iterates
  a 30-entry truth array the same way).

Deviations from darknet (documented, deliberate): the burn-in prior loss
(pushing boxes to anchor shapes for the first 12800 samples) is off by
default, and class loss uses cross-entropy on softmax rather than darknet's
sum-of-squares delta on softmax outputs.

Objectness fidelity note: darknet's region backward applies its delta
``scale*(t - p)`` directly to the pre-activation (backward_region_layer
never multiplies the logistic derivative back in), i.e. the GRADIENT of a
scaled BCE on the logit. The obj/noobj terms here are therefore BCE, not
an autodiffed MSE-on-sigmoid — the latter's extra p(1-p) factor traps
objectness in saturation on large grids (see region_loss body). The x/y
coordinate terms keep MSE on the activated value: their targets live in
(0,1) so the sigmoid never saturates against them.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .graph import NetworkSpec, RegionSpec
from .models import yolov2 as m


@dataclass(frozen=True)
class LossConfig:
    object_scale: float = 5.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0
    thresh: float = 0.6
    rescore: bool = True


def _box_iou_xywh(a, b):
    """IoU of center-format boxes; a (..., 4), b (..., 4)."""
    inter_w = jnp.minimum(a[..., 0] + a[..., 2] / 2, b[..., 0] + b[..., 2] / 2) - \
        jnp.maximum(a[..., 0] - a[..., 2] / 2, b[..., 0] - b[..., 2] / 2)
    inter_h = jnp.minimum(a[..., 1] + a[..., 3] / 2, b[..., 1] + b[..., 3] / 2) - \
        jnp.maximum(a[..., 1] - a[..., 3] / 2, b[..., 1] - b[..., 3] / 2)
    inter = jnp.maximum(inter_w, 0) * jnp.maximum(inter_h, 0)
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / jnp.maximum(union, 1e-9)


def region_loss(head: jnp.ndarray, truth_boxes: jnp.ndarray,
                truth_cls: jnp.ndarray, truth_mask: jnp.ndarray,
                spec: RegionSpec, cfg: LossConfig = LossConfig()) -> jnp.ndarray:
    """head: (B, h, w, n*(5+classes)) raw conv output.
    truth_boxes: (B, M, 4) xywh relative [0,1]; truth_cls: (B, M) int;
    truth_mask: (B, M) {0,1}.
    """
    B, lh, lw, _ = head.shape
    n, classes = spec.num, spec.classes
    x = head.reshape(B, lh, lw, n, 5 + classes)
    anchors = jnp.asarray(spec.biases, jnp.float32).reshape(n, 2)

    sx, sy = jax.nn.sigmoid(x[..., 0]), jax.nn.sigmoid(x[..., 1])
    tw, th = x[..., 2], x[..., 3]
    obj_logit = x[..., 4]
    obj = jax.nn.sigmoid(obj_logit)
    logits = x[..., 5:]

    col = jnp.arange(lw, dtype=jnp.float32)[None, None, :, None]
    row = jnp.arange(lh, dtype=jnp.float32)[None, :, None, None]
    pred = jnp.stack([(col + sx) / lw, (row + sy) / lh,
                      jnp.exp(tw) * anchors[:, 0] / lw,
                      jnp.exp(th) * anchors[:, 1] / lh], axis=-1)  # (B,h,w,n,4)

    # --- noobject loss: every anchor whose best IoU vs any truth <= thresh
    ious_all = _box_iou_xywh(pred[:, :, :, :, None, :],
                             truth_boxes[:, None, None, None, :, :])   # (B,h,w,n,M)
    ious_all = jnp.where(truth_mask[:, None, None, None, :] > 0, ious_all, 0.0)
    best_iou = ious_all.max(axis=-1)
    noobj = (best_iou <= cfg.thresh).astype(jnp.float32)

    # --- per-truth responsible anchor: best shape-IoU at (0,0)
    M = truth_boxes.shape[1]
    tw_h = truth_boxes[..., 2:4]                                      # (B,M,2)
    shape_truth = jnp.concatenate([jnp.zeros_like(tw_h), tw_h], -1)   # (B,M,4)
    anc_wh = jnp.stack([anchors[:, 0] / lw, anchors[:, 1] / lh], -1)  # (n,2)
    shape_anc = jnp.concatenate([jnp.zeros_like(anc_wh), anc_wh], -1)  # (n,4)
    shape_iou = _box_iou_xywh(shape_truth[:, :, None, :],
                              shape_anc[None, None, :, :])            # (B,M,n)
    best_n = jnp.argmax(shape_iou, axis=-1)                           # (B,M)

    ci = jnp.clip((truth_boxes[..., 0] * lw).astype(jnp.int32), 0, lw - 1)
    cj = jnp.clip((truth_boxes[..., 1] * lh).astype(jnp.int32), 0, lh - 1)

    bidx = jnp.arange(B)[:, None] * jnp.ones((1, M), jnp.int32)
    g = (bidx, cj, ci, best_n)

    mask = truth_mask.astype(jnp.float32)
    # darknet overwrites the noobj delta at the truth-assigned slot
    # (region_layer.c: delta[obj_index] is recomputed by the object term),
    # so the responsible anchor must NOT also be pulled toward 0.
    #
    # Objectness terms are BCE on the LOGIT: darknet applies its delta
    # scale*(t - p) straight to the logistic output's pre-activation (no
    # sigmoid-derivative factor), which is exactly BCE's gradient. An
    # autodiffed MSE-on-sigmoid multiplies by p(1-p) instead, and on
    # large grids (416² -> 13x13: ~840 negative slots vs ~5 positives)
    # the noobj pressure drives every logit into saturation first, after
    # which the p(1-p)~=0.005 factor traps the positives at obj~=0
    # forever (measured r5: 2000 steps at 416², train-scene obj max
    # 0.0075, mAP 0.0; the 128² protocol escaped only because its 4x4
    # grid has 10x fewer negatives).
    def bce(logit, target):
        return (jnp.maximum(logit, 0) - logit * target
                + jnp.log1p(jnp.exp(-jnp.abs(logit))))

    assigned = jnp.zeros_like(obj).at[g].max(mask)
    loss_noobj = cfg.noobject_scale * jnp.sum(
        noobj * (1.0 - assigned) * bce(obj_logit, 0.0))

    # gather predictions at assigned slots
    p_sx, p_sy = sx[g], sy[g]
    p_tw, p_th = tw[g], th[g]
    p_logits = logits[g]
    p_box = pred[g]

    t_tx = truth_boxes[..., 0] * lw - ci
    t_ty = truth_boxes[..., 1] * lh - cj
    a_w = anchors[best_n, 0] / lw
    a_h = anchors[best_n, 1] / lh
    t_tw = jnp.log(jnp.maximum(truth_boxes[..., 2], 1e-9) / a_w)
    t_th = jnp.log(jnp.maximum(truth_boxes[..., 3], 1e-9) / a_h)

    loss_coord = cfg.coord_scale * jnp.sum(mask * (
        (p_sx - t_tx) ** 2 + (p_sy - t_ty) ** 2 +
        (p_tw - t_tw) ** 2 + (p_th - t_th) ** 2))

    iou_t = _box_iou_xywh(p_box, truth_boxes)
    target_obj = iou_t if cfg.rescore else jnp.ones_like(iou_t)
    loss_obj = cfg.object_scale * jnp.sum(
        mask * bce(obj_logit[g], jax.lax.stop_gradient(target_obj)))

    logp = jax.nn.log_softmax(p_logits, axis=-1)
    onehot = jax.nn.one_hot(truth_cls, classes)
    loss_cls = cfg.class_scale * jnp.sum(mask * -(onehot * logp).sum(-1))

    total = (loss_noobj + loss_coord + loss_obj + loss_cls) / B
    return total


def make_train_step(spec: NetworkSpec, lr: float = 1e-3,
                    momentum: float = 0.9, cfg: LossConfig = LossConfig(),
                    mesh=None, clip_norm: float = 1.0):
    """SGD+momentum training step over fp32 params (functional, jittable).
    Pass ``mesh`` when running tp-sharded so the forward pins its
    reorg/route boundaries (avoids GSPMD involuntary rematerialization).
    ``clip_norm`` > 0 clips the global gradient norm (0 turns the clip
    off). The default clip is required for the full 23-conv graph, whose
    BN is folded into the weights (the artifact contract stores folded
    weights, weights/README.md:33-59), so nothing renormalizes
    activations: unclipped, yolov2 at 160² and up reaches NaN by its
    third step at the default lr (tests/test_train_parallel.py)."""
    fwd = m.build_forward(spec, "fp32", outputs=("head",), mesh=mesh)
    rspec = spec.region

    def loss_fn(params, batch):
        head = fwd(params, batch["images"])["head"]
        return region_loss(head, batch["boxes"], batch["classes"],
                           batch["mask"], rspec, cfg)

    def train_step(params, velocity, batch, lr_scale=1.0):
        # lr_scale: schedule multiplier on the base lr (warmup/cosine decay
        # live host-side; the step stays a pure function of its arguments)
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        if clip_norm > 0:
            gnorm = jnp.sqrt(sum(
                jnp.sum(g.astype(jnp.float32) ** 2)
                for g in jax.tree_util.tree_leaves(grads)))
            scale = jnp.minimum(1.0, clip_norm / jnp.maximum(gnorm, 1e-9))
            grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
        new_v = jax.tree_util.tree_map(
            lambda v, g: momentum * v - (lr * lr_scale) * g, velocity, grads)
        new_p = jax.tree_util.tree_map(lambda p, v: p + v, params, new_v)
        return new_p, new_v, loss

    return train_step


def zeros_like_velocity(params: dict) -> dict:
    return jax.tree_util.tree_map(jnp.zeros_like, params)
