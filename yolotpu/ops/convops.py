"""Convolution ops: fp32 and integer-quantized, XLA-native (NHWC/HWIO).

The reference computes conv on a Tm=32 x Tn=4 MAC array with the tile loops
of ``hls/models/yolov2/yolo2_accel.cpp:127-168``; here the same work is
plain ``lax`` convolutions and matrix products that XLA hands to the GPU's
libraries — spatial tiling, double buffering and MAC unrolling all come
from the compiler.

INT16 semantics (production path): exact int32 accumulation over the whole
receptive field, then one requantization
    out = sat16( round_shift(acc, Qa_in + Qw - Qa_out) + round_shift(bias, Qb - Qa_out) )
with round-half-up shifts capped at magnitude 30 and int16 saturation,
mirroring ``core_compute.cpp:49-63,86-118`` except that the reference
requantizes after every 4-input-channel group (an FPGA resource artifact that
only loses precision); the bit-exact reproduction of that behavior lives in
``yolotpu.golden.conv_int16_exact`` and is used as a fidelity oracle.

Every integer tier accumulates s8 x s8 -> s32 products (``s8_acc``): the
int8 tier directly, the w8a16 tier over two activation planes, the exact
int16 tier over two activation and two weight planes (``conv_int16``).

Integer leaky activation matches the hardware exactly: ``v < 0 -> v / 10``
with C truncation toward zero (``core_compute.cpp:192-198``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

DN = ("NHWC", "HWIO", "NHWC")

# int16 conv compute implementations
COMPUTE_MODES = ("int32", "f32", "f32_highest")


def pad_same_darknet(x: jnp.ndarray, size: int, stride: int, pad: int,
                     value) -> tuple[jnp.ndarray, str]:
    """Explicit zero/value padding per darknet conv semantics (symmetric
    ``pad`` pixels each side; output (in + 2*pad - size)//stride + 1)."""
    if pad == 0:
        return x, "VALID"
    x = jnp.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                constant_values=value)
    return x, "VALID"


def conv_fp32(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray, stride: int,
              pad: int, activation: str,
              precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """fp32 conv + bias + activation. x (B,H,W,Cin) f32, w (k,k,Cin,Cout).

    Default precision is HIGHEST: true fp32 products. The GPU's DEFAULT
    precision may run f32 convs as TF32 (10-bit mantissa products), which
    is not an acceptable accuracy oracle. Pass precision=None for the fast
    path.
    """
    xp, p = pad_same_darknet(x, w.shape[0], stride, pad, 0.0)
    out = lax.conv_general_dilated(xp, w, (stride, stride), p,
                                   dimension_numbers=DN,
                                   precision=precision,
                                   preferred_element_type=jnp.float32)
    out = out + b
    return activate_fp32(out, activation)


def activate_fp32(x: jnp.ndarray, activation: str) -> jnp.ndarray:
    """All 13 darknet activations (yolo_math.cpp:111-129)."""
    if activation == "linear":
        return x
    if activation == "leaky":
        return jnp.where(x > 0, x, 0.1 * x)
    if activation == "relu":
        return jnp.maximum(x, 0)
    if activation == "logistic":
        return jax.nn.sigmoid(x)
    if activation == "tanh":
        return jnp.tanh(x)
    if activation == "elu":
        return jnp.where(x >= 0, x, jnp.expm1(x))
    if activation == "ramp":
        return x * (x > 0) + 0.1 * x
    if activation == "relie":
        return jnp.where(x > 0, x, 0.01 * x)
    if activation == "loggy":
        return 2.0 * jax.nn.sigmoid(x) - 1.0
    if activation == "plse":
        return jnp.where(x < -4, 0.01 * (x + 4),
                         jnp.where(x > 4, 0.01 * (x - 4) + 1,
                                   0.125 * x + 0.5))
    if activation == "stair":
        nf = jnp.floor(x)
        half = jnp.floor(x / 2.0)
        return jnp.where(jnp.fmod(nf, 2.0) == 0, half, (x - nf) + half)
    if activation == "hardtan":
        return jnp.clip(x, -1.0, 1.0)
    if activation == "lhtan":
        return jnp.where(x < 0, 0.001 * x,
                         jnp.where(x > 1, 0.001 * (x - 1) + 1, x))
    raise NotImplementedError(activation)


def round_shift(v: jnp.ndarray, shift: int) -> jnp.ndarray:
    """Static arithmetic shift with round-half-up on right shifts, magnitude
    capped at 30 (int64 not needed: partial sums fit int32 after conv's int32
    accumulation contract; see core_compute.cpp:49-63)."""
    if shift > 0:
        mag = min(shift, 30)
        return (v + (1 << (mag - 1))) >> mag
    if shift < 0:
        return v << min(-shift, 30)
    return v


def round_shift_vec(v: jnp.ndarray, shift) -> jnp.ndarray:
    """``round_shift`` with a per-lane shift vector (broadcast against the
    minor axis) — the per-channel int8 requant path. Semantics per lane are
    identical to the static version (round-half-up right shift / plain left
    shift, magnitude capped at 30)."""
    s = jnp.asarray(shift, jnp.int32)
    spos = jnp.clip(s, 0, 30)
    half = jnp.where(s > 0,
                     jnp.left_shift(jnp.int32(1), jnp.maximum(spos - 1, 0)),
                     0)
    return jnp.where(s > 0, (v + half) >> spos, v << jnp.clip(-s, 0, 30))


def sat16(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(v, -32768, 32767)


def leaky_int16(v: jnp.ndarray) -> jnp.ndarray:
    """v < 0 -> v/10 with truncation toward zero (core_compute.cpp:192-198).
    Input int32 in int16 range; output int32."""
    neg = -((-v) // 10)     # trunc-toward-zero for v<0
    return jnp.where(v < 0, neg, v)


def _requant(acc: jnp.ndarray, bias_shifted, shift_out, activation: str,
             lo: int, hi: int) -> jnp.ndarray:
    """One requantization: round-half-up shift (static or per-channel),
    pre-shifted bias, saturation to [lo, hi], integer leaky. int32 out."""
    rs = (round_shift if isinstance(shift_out, (int, np.integer))
          else round_shift_vec)
    v = jnp.clip(rs(acc, shift_out) + bias_shifted, lo, hi)
    if activation == "leaky":
        v = jnp.clip(leaky_int16(v), lo, hi)
    elif activation != "linear":
        raise NotImplementedError(f"integer activation {activation}")
    return v


def _im2col(xp: jnp.ndarray, kh: int, kw: int, stride: int) -> jnp.ndarray:
    """(B,H,W,C) padded -> (B,Ho,Wo,kh*kw*C), tap-major like an HWIO
    weight reshaped to (kh*kw*C, N)."""
    b, h, w, c = xp.shape
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    taps = [xp[:, dy:dy + (ho - 1) * stride + 1:stride,
               dx:dx + (wo - 1) * stride + 1:stride, :]
            for dy in range(kh) for dx in range(kw)]
    return jnp.concatenate(taps, axis=-1)


def s8_acc(xp: jnp.ndarray, w: jnp.ndarray, stride: int) -> jnp.ndarray:
    """Exact s8 x s8 -> s32 VALID convolution of an already-padded NHWC
    input with HWIO weights, as one im2col matrix product (the GPU's
    integer GEMM; cuDNN takes no s8 convolution with s32 output).
    Input channels are zero-padded to a multiple of 4, the integer GEMM's
    granularity; zero weights make the pad contribute nothing whatever the
    activation value."""
    kh, kw, c, n = w.shape
    if c % 4:
        cp = 4 - c % 4
        xp = jnp.pad(xp, ((0, 0), (0, 0), (0, 0), (0, cp)))
        w = jnp.pad(w, ((0, 0), (0, 0), (0, cp), (0, 0)))
        c += cp
    cols = _im2col(xp, kh, kw, stride)
    b_, h_, w_, k_ = cols.shape
    return jnp.dot(cols.reshape(-1, k_), w.reshape(k_, n),
                   preferred_element_type=jnp.int32).reshape(b_, h_, w_, n)


def split16(v: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """int16 -> (hi, lo) s8 planes with v == 256*hi + lo + 128: hi = v >> 8,
    lo = (v & 255) - 128. An int16 zero (SAME padding) encodes as
    (0, -128)."""
    return ((v >> 8).astype(jnp.int8),
            (jnp.bitwise_and(v, 255) - 128).astype(jnp.int8))


def prep_weights_int16(w) -> tuple[jnp.ndarray, jnp.ndarray]:
    """int16 HWIO weights -> the exact-int16 conv's weight planes
    ``(wp, cw)``: wp = [wh | wl | 1] (kh, kw, C, 2N+1) s8 with
    w == 256*wh + wl + 128 (``split16``) and an all-ones column, and
    cw = 128 * sum_taps(w) per output channel (int32, wraparound)."""
    w = jnp.asarray(w)
    wh, wl = split16(w)
    wp = jnp.concatenate([wh, wl, jnp.ones(w.shape[:3] + (1,), jnp.int8)],
                         axis=3)
    return wp, 128 * jnp.sum(w.astype(jnp.int32), axis=(0, 1, 2))


def _acc_int16(xp: jnp.ndarray, wp: jnp.ndarray, cw: jnp.ndarray,
               stride: int) -> jnp.ndarray:
    """Exact int16 x int16 -> int32 (wraparound) VALID conv accumulation
    from s8 planes. x == 256*xh + xl + 128 and w == 256*wh + wl + 128, so
        sum x*w = 65536 A(xh,wh) + 256 (A(xh,wl) + A(xl,wh)) + A(xl,wl)
                  + 128 (256 S(xh) + S(xl)) + 128 sum w
    with A the s8 accumulation and S(.) the receptive-field sum (the
    all-ones column of ``wp``). Every term wraps mod 2^32 like an s16
    accumulation would; s8 partials fit int32 (128*128*K < 2^31)."""
    n = cw.shape[0]
    xh, xl = split16(xp)
    ah = s8_acc(xh, wp, stride)
    al = s8_acc(xl, wp, stride)
    return ((ah[..., :n] << 16) + ((ah[..., n:2 * n] + al[..., :n]) << 8)
            + al[..., n:2 * n]
            + 128 * ((ah[..., 2 * n:] << 8) + al[..., 2 * n:]) + cw)


def conv_int16(x: jnp.ndarray, w: jnp.ndarray, bias_shifted: jnp.ndarray,
               stride: int, pad: int, activation: str, shift_out: int,
               compute: str = "int32") -> jnp.ndarray:
    """Quantized conv. x (B,H,W,Cin) int16, w (k,k,Cin,Cout) int16,
    bias_shifted (Cout,) int32 already in the Qa_out domain.

    compute:
      - "int32":       exact int32 accumulation (bit-exact vs golden); the
                       weight planes are split in-graph on every call, so
                       a Cout-sharded ``w`` gives Cout-sharded planes
      - "f32":         cast to f32 at the backend's default precision
                       (TF32 on the GPU): approximate
      - "f32_highest": f32 with exact products, f32 accumulation:
                       approximate once sums pass 2^24
    Returns int16 activations.
    """
    xp, _ = pad_same_darknet(x, w.shape[0], stride, pad, jnp.int16(0))
    if compute == "int32":
        acc = _acc_int16(xp, *prep_weights_int16(w), stride)
    elif compute in ("f32", "f32_highest"):
        prec = (lax.Precision.HIGHEST if compute == "f32_highest" else None)
        accf = lax.conv_general_dilated(xp.astype(jnp.float32),
                                        w.astype(jnp.float32),
                                        (stride, stride), "VALID",
                                        dimension_numbers=DN,
                                        precision=prec,
                                        preferred_element_type=jnp.float32)
        acc = jnp.round(accf).astype(jnp.int32)
    else:
        raise ValueError(f"compute mode {compute!r}")
    return _requant(acc, bias_shifted, shift_out, activation,
                    -32768, 32767).astype(jnp.int16)


def prep_weights_w8a16(w8: "np.ndarray") -> "np.ndarray":
    """Activation lo-plane offset correction for the w8a16 engine:
    cw = 128 * sum_taps(w8) per output channel (int32, wraparound)."""
    cw = (128 * np.asarray(w8).astype(np.int64).sum(axis=(0, 1, 2)))
    return (cw & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def conv_w8a16(x: jnp.ndarray, w8: jnp.ndarray, cw: jnp.ndarray,
               bias_shifted: jnp.ndarray, stride: int, pad: int,
               activation: str, shift_out) -> jnp.ndarray:
    """w8a16 tier conv: int16 activations x int8 per-channel weights as ONE
    s8 x s8 accumulation over batch-concatenated (hi, lo) activation planes
    (``split16``; the per-tap +128 of the lo plane is folded into ``cw``):
        acc = (A(xh, w8) << 8) + A(xl, w8) + cw        (mod 2^32)
    The true accumulation fits int32 (quantize_weights_w8a16 caps the
    requant shift exactly like the int16 tier's Qw cap), so the wraparound
    reconstruction is exact. Half the int16 tier's s8 work because 8-bit
    weights need no hi/lo weight planes; the cost is ~1 weight LSB, repaid
    by per-channel scales (quant.quantize_weights_w8a16).

    ``shift_out``: int or per-output-channel (N,) vector.
    """
    xp, _ = pad_same_darknet(x, w8.shape[0], stride, pad, jnp.int16(0))
    xh, xl = split16(xp)
    b_ = x.shape[0]
    a = s8_acc(jnp.concatenate([xh, xl], axis=0), w8, stride)
    acc = (a[:b_] << 8) + a[b_:] + cw
    return _requant(acc, bias_shifted, shift_out, activation,
                    -32768, 32767).astype(jnp.int16)


def conv_int8(x: jnp.ndarray, w: jnp.ndarray, bias_shifted: jnp.ndarray,
              stride: int, pad: int, activation: str, shift_out,
              head16: bool = False) -> jnp.ndarray:
    """w8a8 turbo conv: int8 x int8 -> int32, one requant.

    Same fixed-point structure as conv_int16 but at 8-bit scales (the int8
    tier trades ~1 bit of activation precision for a quarter of the int16
    tier's s8 work).

    ``shift_out`` is a python int (per-layer scales) or an (N,) array
    (per-channel weight scales, quant.quantize_weights_int8 default): the
    requant shift broadcasts over output channels.

    ``head16``: detection-head epilogue — requant to int16 at an 8-bits-finer
    scale (shift-8, bias<<8). 8-bit region logits quantize the box
    regression away; 16-bit ones are free — the head conv is <1% of the
    model's MACs and nothing consumes its output on-device except the
    dequantizing region decode.
    """
    xp, _ = pad_same_darknet(x, w.shape[0], stride, pad, jnp.int8(0))
    acc = s8_acc(xp, w, stride)
    if head16:
        return _requant(acc, bias_shifted.astype(jnp.int32) << 8,
                        shift_out - 8, activation,
                        -32768, 32767).astype(jnp.int16)
    return _requant(acc, bias_shifted, shift_out, activation,
                    -128, 127).astype(jnp.int8)


def quantize_input_int8(x: jnp.ndarray, q: int) -> jnp.ndarray:
    """fp32 -> int8 at scale 2**q, round half away from zero."""
    v = jnp.clip(x * jnp.float32(2.0 ** q), -128.0, 127.0)
    r = jnp.where(v >= 0, jnp.floor(v + 0.5), jnp.ceil(v - 0.5))
    return r.astype(jnp.int8)


def dequantize_int8(x: jnp.ndarray, q: int) -> jnp.ndarray:
    return x.astype(jnp.float32) * jnp.float32(2.0 ** (-q))


def quantize_input_int16(x: jnp.ndarray, q: int) -> jnp.ndarray:
    """fp32 -> int16 at scale 2**q, round half away from zero with fp32
    pre-clamp (yolo2_model.cpp:257-273 llround semantics)."""
    v = x * jnp.float32(2.0 ** q)
    v = jnp.clip(v, -32768.0, 32767.0)
    r = jnp.where(v >= 0, jnp.floor(v + 0.5), jnp.ceil(v - 0.5))
    return r.astype(jnp.int16)


def dequantize_int16(x: jnp.ndarray, q: int) -> jnp.ndarray:
    return x.astype(jnp.float32) * jnp.float32(2.0 ** (-q))


def realign_int16(x: jnp.ndarray, shift: int) -> jnp.ndarray:
    """Reorg-branch Q realignment before a concat: plain arithmetic shift
    (NO rounding — yolo2_model.cpp:385-393) with saturation to the input's
    own integer range (int16 or int8 tier)."""
    lo, hi = jnp.iinfo(x.dtype).min, jnp.iinfo(x.dtype).max
    v = x.astype(jnp.int32)
    v = (v >> shift) if shift > 0 else (v << -shift)
    return jnp.clip(v, lo, hi).astype(x.dtype)
