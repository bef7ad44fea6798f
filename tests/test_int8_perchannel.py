"""Per-channel int8 weight scales (quant.quantize_weights_int8 default).

The w8a8 tier keeps the reference-style per-layer activation iofm table
but gives each OUTPUT CHANNEL its own power-of-two weight/bias exponent;
the requant shift becomes an (N,) vector broadcast in the conv epilogue.
These tests pin: the conv path against the numpy golden twin, scale
quality vs the per-layer mode, and full-net bit-exactness jax-vs-golden.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from yolotpu import golden
from yolotpu.graph import ConvSpec
from yolotpu.models import yolov2, zoo
from yolotpu.ops import convops
from yolotpu.quant import (calibrate_activations_int8, dequantize_tensor,
                           quantize_weights_int8)
from yolotpu.weights import WeightStore


def test_conv_int8_perchannel_matches_numpy_twin():
    rng = np.random.default_rng(1)
    spec = ConvSpec(idx=0, h=16, w=16, c=32, out_h=16, out_w=16, out_c=24,
                    n=24, size=3, stride=1, pad=1, activation="leaky")
    x = rng.integers(-128, 128, (32, 16, 16)).astype(np.int8)
    w = rng.integers(-128, 128, (24, 32, 3, 3)).astype(np.int8)
    b = rng.integers(-100, 100, 24).astype(np.int8)
    qa_in, qa_out = 4, 3
    qw = rng.integers(3, 9, 24).astype(np.int32)
    qb = rng.integers(2, 8, 24).astype(np.int32)
    want = golden.conv_int8_int32acc(x, w, b, spec, qw, qa_in, qa_out, qb)

    bias_shifted = golden.shift_round_half_up(
        b.astype(np.int64), qb - qa_out).astype(np.int32)
    got = np.asarray(convops.conv_int8(
        jnp.asarray(x.transpose(1, 2, 0)[None]),
        jnp.asarray(w.transpose(2, 3, 1, 0)),
        jnp.asarray(bias_shifted), 1, 1, "leaky",
        qa_in + qw - qa_out))[0].transpose(2, 0, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_perchannel_scales_cut_weight_quant_error():
    """Per-channel exponents must reconstruct the fp32 weights strictly
    better than one per-layer exponent when channel magnitudes vary.
    slow: two calibration passes (golden forwards) of the 64-input
    graph."""
    spec = zoo.build("yolov2", width=64, height=64)
    store_pl = WeightStore.synthetic(spec, seed=0)
    # skew channel magnitudes so the per-layer absmax is a bad fit
    for idx, (w, b) in store_pl.fp32.items():
        scale = np.logspace(-2, 0, w.shape[0]).reshape(-1, 1, 1, 1)
        store_pl.fp32[idx] = (w * scale.astype(np.float32), b)
    store_pc = WeightStore.synthetic(spec, seed=0)
    store_pc.fp32 = {k: (w.copy(), b.copy())
                     for k, (w, b) in store_pl.fp32.items()}
    img = np.random.default_rng(3).random((3, 64, 64)).astype(np.float32)
    q8 = calibrate_activations_int8(spec, store_pl, [img])
    quantize_weights_int8(store_pl, q8, per_channel=False)
    quantize_weights_int8(store_pc, q8, per_channel=True)
    worse = better = 0
    for ci, l in enumerate(spec.conv_layers()):
        wf = store_pl.fp32[l.idx][0]
        w_pl = dequantize_tensor(store_pl.int8[l.idx][0],
                                 store_pl.qtables8.weight_q[ci])
        qpc = np.asarray(store_pc.qtables8.weight_q[ci]).reshape(-1, 1, 1, 1)
        w_pc = store_pc.int8[l.idx][0].astype(np.float32) * (2.0 ** -qpc)
        e_pl = float(np.abs(w_pl - wf).mean())
        e_pc = float(np.abs(w_pc - wf).mean())
        if e_pc < e_pl:
            better += 1
        elif e_pc > e_pl * 1.0001:
            worse += 1
    assert better >= len(spec.conv_layers()) - 1 and worse == 0, \
        (better, worse)


@pytest.mark.slow
def test_int8_perchannel_forward_bitexact_vs_golden():
    """Full 64-input yolov2 graph: jax int8 forward with per-channel tables
    is bit-exact vs the golden twin (same route/reorg Q routing)."""
    from yolotpu.golden import GoldenNet
    spec = zoo.build("yolov2", width=64, height=64)
    store = WeightStore.synthetic(spec, seed=0)
    rng = np.random.default_rng(9)
    img = rng.random((3, 64, 64)).astype(np.float32)
    act_q8 = calibrate_activations_int8(spec, store, [img])
    quantize_weights_int8(store, act_q8, per_channel=True)
    g = GoldenNet(spec).forward_int16(img, store.int8, store.qtables8,
                                      mode="int8")
    params8 = yolov2.params_int8(spec, store)
    f8 = yolov2.build_forward(spec, "int8", store.qtables8, outputs=("head",))
    head = np.asarray(f8(params8, jnp.asarray(
        img.transpose(1, 2, 0)[None]))["head"])[0].transpose(2, 0, 1)
    np.testing.assert_array_equal(head, g[spec.n - 1])
