"""On-device region-head decode (batched, fixed shapes).

Equivalent to ``forward_region_layer`` + ``get_region_box``
(``src/core/yolo_region.cpp:18-26,123-141``) but vectorized over the whole
grid so the device emits only small fixed-size tensors per frame:

    boxes  (B, h*w*n, 4)   center-format, relative to the network input
    obj    (B, h*w*n)      objectness (post-sigmoid)
    probs  (B, h*w*n, classes)  softmax class probabilities (NOT yet
                             multiplied by objectness / thresholded —
                             host postprocess applies the darknet
                             ``prob = obj * p > thresh`` rule)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..graph import RegionSpec


def _activate_obj_cls(x: jnp.ndarray, spec: RegionSpec):
    """Objectness + class activation honoring the cfg's ``softmax`` and
    ``background`` options exactly as ``forward_region_layer`` does
    (yolo_region.cpp:123-141): obj is logistic unless background=1; the
    softmax (when softmax=1) runs over classes+background entries starting
    at coords + !background, sourced from the RAW tensor. Detection reads
    entry ``coords`` as objectness and ``coords+1+j`` as class j
    (yolo_region.cpp:169-195), so with background=1 the objectness IS the
    softmax's background component."""
    coords = spec.coords
    tobj = x[..., coords]
    if spec.background:
        if spec.softmax:
            sm = jax.nn.softmax(x[..., coords:], axis=-1)
            return sm[..., 0], sm[..., 1:]
        return tobj, x[..., coords + 1:]
    obj = jax.nn.sigmoid(tobj)
    tcls = x[..., coords + 1:]
    probs = jax.nn.softmax(tcls, axis=-1) if spec.softmax else tcls
    return obj, probs


def decode_region(head: jnp.ndarray, spec: RegionSpec):
    """head: (B, h, w, n*(coords+classes+1)) fp32 raw conv output."""
    bsz, lh, lw, _ = head.shape
    n, coords, classes = spec.num, spec.coords, spec.classes
    x = head.reshape(bsz, lh, lw, n, coords + classes + 1)

    tx, ty = x[..., 0], x[..., 1]
    tw, th = x[..., 2], x[..., 3]

    col = jnp.arange(lw, dtype=jnp.float32)[None, None, :, None]
    row = jnp.arange(lh, dtype=jnp.float32)[None, :, None, None]
    biases = jnp.asarray(spec.biases, jnp.float32).reshape(n, 2)

    bx = (col + jax.nn.sigmoid(tx)) / lw
    by = (row + jax.nn.sigmoid(ty)) / lh
    bw = jnp.exp(tw) * biases[:, 0] / lw
    bh = jnp.exp(th) * biases[:, 1] / lh
    obj, probs = _activate_obj_cls(x, spec)

    # flatten in darknet's detection iteration order: cell-major, anchor-minor
    # (get_region_detections loops i over h*w then n; yolo_region.cpp:174-193)
    boxes = jnp.stack([bx, by, bw, bh], axis=-1).reshape(bsz, lh * lw * n, 4)
    return boxes, obj.reshape(bsz, -1), probs.reshape(bsz, lh * lw * n, classes)


def activated_head(head: jnp.ndarray, spec: RegionSpec) -> jnp.ndarray:
    """forward_region_layer equivalent: the full activated tensor in NHWC
    (sigmoid x/y/obj, softmax classes, w/h raw) — used for dump parity."""
    bsz, lh, lw, _ = head.shape
    n, coords, classes = spec.num, spec.coords, spec.classes
    x = head.reshape(bsz, lh, lw, n, coords + classes + 1)
    xy = jax.nn.sigmoid(x[..., :2])
    wh = x[..., 2:coords]
    obj, cls = _activate_obj_cls(x, spec)
    out = jnp.concatenate([xy, wh, obj[..., None], cls], axis=-1)
    return out.reshape(bsz, lh, lw, n * (coords + classes + 1))
