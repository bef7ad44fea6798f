"""Exact int16 tier: the s8-plane route (ops.convops.conv_int16,
compute="int32") against the golden numpy twin, per conv class of the
model zoo at real channel widths, plus the arithmetic's edges: full-range
s16 operands, the C=3 entry padding and int32 wraparound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exact_cases import CLASSES, class_id, make_case, run_case
from yolotpu.ops import convops


@pytest.mark.parametrize("cls", CLASSES, ids=class_id)
def test_int16_conv_class_matches_golden(cls):
    case = make_case("int16", cls, seed=1)
    got = run_case(case, jax.devices("cpu")[0])
    np.testing.assert_array_equal(got, case["want"])


def _acc_ref(x, w, stride, pad):
    """int64 im2col accumulation wrapped to int32 (the s16 contract)."""
    xp = np.pad(x.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    kh, kw, _, n = w.shape
    ho = (xp.shape[1] - kh) // stride + 1
    wo = (xp.shape[2] - kw) // stride + 1
    acc = np.zeros((x.shape[0], ho, wo, n), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            acc += xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                      dx:dx + (wo - 1) * stride + 1:stride, :] \
                @ w[dy, dx].astype(np.int64)
    return ((acc + 2**31) % 2**32 - 2**31).astype(np.int32)


def _acc(x, w, stride, pad):
    xp, _ = convops.pad_same_darknet(jnp.asarray(x), w.shape[0], stride, pad,
                                     jnp.int16(0))
    wp, cw = convops.prep_weights_int16(w)
    return np.asarray(jax.jit(
        lambda a, b, c: convops._acc_int16(a, b, c, stride))(
            xp, jnp.asarray(wp), jnp.asarray(cw)))


@pytest.mark.parametrize("k,c,n,stride", [
    (3, 3, 32, 1),       # entry conv: C=3 pads to 4 inside s8_acc
    (3, 5, 7, 1),        # odd widths
    (1, 64, 32, 1),      # 1x1
    (3, 16, 24, 2),      # strided
])
def test_int16_full_range_wraps_like_s16(k, c, n, stride):
    """Full-range s16 operands (sums overflow int32): the plane route must
    wrap exactly like an s16 x s16 -> s32 accumulation."""
    rng = np.random.default_rng(k * 100 + c)
    x = rng.integers(-32768, 32768, (2, 9, 9, c)).astype(np.int16)
    w = rng.integers(-32768, 32768, (k, k, c, n)).astype(np.int16)
    np.testing.assert_array_equal(_acc(x, w, stride, k // 2),
                                  _acc_ref(x, w, stride, k // 2))


@pytest.mark.parametrize("xv,wv", [(32767, 32767), (-32768, -32768),
                                   (-32768, 32767), (32767, -32768)])
def test_int16_extremes(xv, wv):
    """Constant extreme operands: every plane takes its edge value
    (hi = +127/-128, lo = +127/-128) and the sum wraps mod 2^32."""
    x = np.full((1, 4, 4, 64), xv, np.int16)
    w = np.full((3, 3, 64, 8), wv, np.int16)
    np.testing.assert_array_equal(_acc(x, w, 1, 1), _acc_ref(x, w, 1, 1))


def test_int16_wraparound_edge():
    """Accumulations straddling +-2^31: the true sum leaves int32 by a
    few units in both directions and must wrap, not saturate."""
    c = 2
    x = np.zeros((1, 1, 2, c), np.int16)
    w = np.zeros((1, 1, c, 2), np.int16)
    x[0, 0, 0] = (32767, 32767)              # 2*32767^2 = 2^31 - 131070
    x[0, 0, 1] = (-32768, -32768)            # 2*2^30 = 2^31 (wraps)
    w[0, 0, :, 0] = (32767, 32767)
    w[0, 0, :, 1] = (-32768, -32768)
    np.testing.assert_array_equal(_acc(x, w, 1, 0), _acc_ref(x, w, 1, 0))
    assert _acc(x, w, 1, 0)[0, 0, 1, 1] == -(2**31)


def test_split16_and_weight_planes_reconstruct():
    v = np.arange(-32768, 32768, dtype=np.int16)
    hi, lo = (np.asarray(a) for a in convops.split16(jnp.asarray(v)))
    assert hi.dtype == lo.dtype == np.int8
    np.testing.assert_array_equal(
        256 * hi.astype(np.int32) + lo.astype(np.int32) + 128, v)
    w = np.random.default_rng(3).integers(
        -32768, 32768, (3, 3, 5, 4)).astype(np.int16)
    wp, cw = convops.prep_weights_int16(w)
    assert wp.shape == (3, 3, 5, 9) and wp.dtype == np.int8
    np.testing.assert_array_equal(
        256 * wp[..., :4].astype(np.int32) + wp[..., 4:8] + 128, w)
    assert np.all(wp[..., 8] == 1)
    want = (128 * w.astype(np.int64).sum(axis=(0, 1, 2)) + 2**31) \
        % 2**32 - 2**31
    np.testing.assert_array_equal(cw, want)
