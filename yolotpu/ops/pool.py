"""Maxpool with darknet window anchoring.

Darknet anchors each window at (r*stride, c*stride) and pads only at the
bottom/right with a value that never wins the max: -32768 for int16, a large
negative number for fp32 (``hls/core/core_compute.cpp:266-305`` and output
dims ``src/core/yolo_layers.cpp:289-310``: out = (in + padding - size)//stride + 1).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def maxpool(x: jnp.ndarray, size: int, stride: int, padding: int) -> jnp.ndarray:
    """x (B,H,W,C); returns (B, (H+padding-size)//stride+1, ..., C).

    Implemented as a max over size^2 shifted strided views rather than
    ``lax.reduce_window`` (whose generic linearization rule fails under jit
    in this JAX version); XLA fuses both forms to the same loop, and this one
    differentiates cleanly for training.
    """
    b, h, w, c = x.shape
    out_h = (h + padding - size) // stride + 1
    out_w = (w + padding - size) // stride + 1
    need_h = (out_h - 1) * stride + size
    need_w = (out_w - 1) * stride + size
    if jnp.issubdtype(x.dtype, jnp.integer):
        neg = jnp.iinfo(x.dtype).min
    else:
        neg = -jnp.inf
    pad_h, pad_w = max(0, need_h - h), max(0, need_w - w)
    if pad_h or pad_w:
        x = jnp.pad(x, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)),
                    constant_values=neg)

    if stride == size and h % stride == 0 and w % stride == 0 and not (pad_h or pad_w):
        # non-overlapping window: reshape + max, no strided slices
        v = x.reshape(b, out_h, stride, out_w, stride, c)
        return jnp.max(jnp.max(v, axis=4), axis=2)

    out = None
    for i in range(size):
        for j in range(size):
            v = lax.slice(x, (0, i, j, 0),
                          (b, i + (out_h - 1) * stride + 1,
                           j + (out_w - 1) * stride + 1, c),
                          (1, stride, stride, 1))
            out = v if out is None else jnp.maximum(out, v)
    return out
