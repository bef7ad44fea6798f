"""w8a16 tier: per-channel int8 weights x int16 activations as one s8
accumulation over batch-stacked (hi, lo) activation planes (ops.convops.conv_w8a16).

Pins: the plane-split + int32-wraparound reconstruction against the int64
golden twin, the quantizer's table shapes and shift cap, and full-net
bit-exactness jax-vs-golden through the route/reorg Q routing.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from yolotpu import golden
from yolotpu.graph import ConvSpec
from yolotpu.models import yolov2, zoo
from yolotpu.ops import convops
from yolotpu.quant import (calibrate_activations, quantize_weights,
                           quantize_weights_w8a16)
from yolotpu.weights import WeightStore


@pytest.mark.parametrize("act,stride", [("leaky", 1), ("linear", 2)])
def test_conv_w8a16_matches_numpy_twin(act, stride):
    rng = np.random.default_rng(1)
    C, N, H = 32, 24, 16
    oh = H // stride
    spec = ConvSpec(idx=0, h=H, w=H, c=C, out_h=oh, out_w=oh, out_c=N,
                    n=N, size=3, stride=stride, pad=1, activation=act)
    x = rng.integers(-32768, 32768, (C, H, H)).astype(np.int16)
    w = rng.integers(-128, 128, (N, C, 3, 3)).astype(np.int8)
    b = rng.integers(-30000, 30000, N).astype(np.int16)
    qa_in, qa_out = 4, 3
    qw = rng.integers(2, 8, N).astype(np.int32)
    qb = rng.integers(2, 8, N).astype(np.int32)
    want = golden.conv_w8a16_int32acc(x, w, b, spec, qw, qa_in, qa_out, qb)

    bias_shifted = golden.shift_round_half_up(
        b.astype(np.int64), qb - qa_out).astype(np.int32)
    w_hwio = w.transpose(2, 3, 1, 0)
    got = np.asarray(convops.conv_w8a16(
        jnp.asarray(x.transpose(1, 2, 0)[None]),
        jnp.asarray(np.ascontiguousarray(w_hwio)),
        jnp.asarray(convops.prep_weights_w8a16(w_hwio)),
        jnp.asarray(bias_shifted), stride, 1, act,
        qa_in + qw - qa_out))[0].transpose(2, 0, 1)
    np.testing.assert_array_equal(got, want)


def test_conv_w8a16_batch_plane_stacking():
    """Multi-batch: the 2B plane stack must split back per-image."""
    rng = np.random.default_rng(2)
    B, C, N, H = 3, 16, 8, 8
    spec = ConvSpec(idx=0, h=H, w=H, c=C, out_h=H, out_w=H, out_c=N,
                    n=N, size=3, stride=1, pad=1, activation="leaky")
    x = rng.integers(-32768, 32768, (B, C, H, H)).astype(np.int16)
    w = rng.integers(-128, 128, (N, C, 3, 3)).astype(np.int8)
    b = np.zeros(N, np.int16)
    w_hwio = w.transpose(2, 3, 1, 0)
    got = np.asarray(convops.conv_w8a16(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(np.ascontiguousarray(w_hwio)),
        jnp.asarray(convops.prep_weights_w8a16(w_hwio)),
        jnp.zeros(N, jnp.int32), 1, 1, "leaky", 7))
    for i in range(B):
        want = golden.conv_w8a16_int32acc(x[i], w, b, spec, 7, 4, 4, 4)
        np.testing.assert_array_equal(got[i].transpose(2, 0, 1), want)


@pytest.mark.slow
def test_quantize_weights_w8a16_tables():
    # slow: calibration runs a golden fp32 forward of the 64-input graph
    spec = zoo.build("yolov2", width=64, height=64)
    store = WeightStore.synthetic(spec, seed=0)
    img = np.random.default_rng(3).random((3, 64, 64)).astype(np.float32)
    act_q = calibrate_activations(spec, store, [img])
    quantize_weights_w8a16(store, act_q)
    qt = store.qtables_w8
    assert qt.act_q == act_q           # int16 iofm, unchanged
    for ci, l in enumerate(spec.conv_layers()):
        w8, b16 = store.w8a16[l.idx]
        assert w8.dtype == np.int8 and b16.dtype == np.int16
        qw = np.asarray(qt.weight_q[ci])
        assert qw.shape == (l.n,)
        # requant shift capped like the int16 tier's Qw cap
        shift = act_q[ci] + qw - act_q[ci + 1]
        assert shift.max() <= 12


@pytest.mark.slow
def test_w8a16_forward_bitexact_vs_golden():
    from yolotpu.golden import GoldenNet
    spec = zoo.build("yolov2", width=64, height=64)
    store = WeightStore.synthetic(spec, seed=0)
    rng = np.random.default_rng(9)
    img = rng.random((3, 64, 64)).astype(np.float32)
    act_q = calibrate_activations(spec, store, [img])
    quantize_weights(store, act_q)
    quantize_weights_w8a16(store, act_q)
    g = GoldenNet(spec).forward_int16(img, store.w8a16, store.qtables_w8,
                                      mode="w8a16")
    params = yolov2.params_w8a16(spec, store)
    fw = yolov2.build_forward(spec, "w8a16", store.qtables_w8,
                              outputs=("head",))
    head = np.asarray(fw(params, jnp.asarray(
        img.transpose(1, 2, 0)[None]))["head"])[0].transpose(2, 0, 1)
    np.testing.assert_array_equal(head, g[spec.n - 1])


@pytest.mark.slow
def test_w8a16_head_tracks_fp32():
    """8-bit per-channel weights on 16-bit activations should track the
    fp32 head closely (the accuracy rationale for the tier). slow: two
    full golden forwards of the 64-input graph."""
    spec = zoo.build("yolov2", width=64, height=64)
    store = WeightStore.synthetic(spec, seed=0)
    rng = np.random.default_rng(5)
    img = rng.random((3, 64, 64)).astype(np.float32)
    act_q = calibrate_activations(spec, store, [img])
    quantize_weights_w8a16(store, act_q)
    g = golden.GoldenNet(spec)
    h8 = g.forward_int16(img, store.w8a16, store.qtables_w8,
                         mode="w8a16")[spec.n - 1]
    h32 = g.forward_fp32(img, store.fp32)[spec.n - 1]
    corr = np.corrcoef(np.asarray(h8).ravel(), np.asarray(h32).ravel())[0, 1]
    assert corr > 0.999, corr
