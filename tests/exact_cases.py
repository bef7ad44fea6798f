"""Integer-tier conv cases shared by the CPU exact-route tests and the
card-only tests: one case per distinct conv class of the model zoo, at a
small spatial size and the model's real channel widths.

A case carries the jax conv's inputs and the numpy twin's answer
(``yolotpu.golden``). Value ranges keep every true accumulation inside
int32 (the contract the quantizer guarantees), so the twin's int64
accumulation and the jax int32 one must agree bit for bit.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from yolotpu import golden
from yolotpu.graph import ConvSpec
from yolotpu.models import zoo
from yolotpu.ops import convops

HW = 6          # input spatial size of every case
TIERS = ("int16", "int8", "w8a16")


def conv_classes(models=("yolov2", "yolov2-tiny")) -> list[tuple]:
    """Distinct (size, stride, C, N, activation) over the models' convs."""
    seen: list[tuple] = []
    for name in models:
        for l in zoo.build(name).conv_layers():
            key = (l.size, l.stride, l.c, l.n, l.activation)
            if key not in seen:
                seen.append(key)
    return seen


CLASSES = conv_classes()


def class_id(cls: tuple) -> str:
    size, stride, c, n, act = cls
    return f"{size}x{size}s{stride}-{c}-{n}-{act}"


def make_case(tier: str, cls: tuple, seed: int = 0) -> dict:
    """Inputs for the tier's jax conv plus the numpy twin's output."""
    size, stride, c, n, act = cls
    pad = size // 2
    out = (HW + 2 * pad - size) // stride + 1
    spec = ConvSpec(idx=0, h=HW, w=HW, c=c, out_h=out, out_w=out, out_c=n,
                    n=n, size=size, stride=stride, pad=pad, activation=act)
    rng = np.random.default_rng(seed)
    k = size * size * c
    if tier == "int8":
        ax, aw = 128, 128                      # 128*128*K < 2^31 always
    elif tier == "w8a16":
        aw = 128
        ax = min(32768, (1 << 31) // (k * aw))
    else:
        ax = aw = min(32768, int(math.isqrt((1 << 31) // k)))
    xdt, wdt = {"int16": (np.int16, np.int16), "int8": (np.int8, np.int8),
                "w8a16": (np.int16, np.int8)}[tier]
    x = rng.integers(-ax, ax, (c, HW, HW)).astype(xdt)
    w = rng.integers(-aw, aw, (n, c, size, size)).astype(wdt)
    b = rng.integers(-3000, 3000, n).astype(np.int16)
    # requant shift that lands typical outputs around +-2^10
    typical = math.sqrt(k) * ax * aw / 3
    shift = max(0, round(math.log2(typical)) - 10)
    qa_in = qa_out = 6
    head16 = tier == "int8" and act == "linear"
    if tier == "int16":
        qw, qb = shift, 8
    else:                                      # per-channel exponents
        qw = (shift + rng.integers(-1, 2, n)).astype(np.int32)
        qb = rng.integers(6, 10, n).astype(np.int32)
    if tier == "int16":
        want = golden.conv_int16_int32acc(x, w, b, spec, qw, qa_in, qa_out,
                                          qb)
    elif tier == "int8":
        want = golden.conv_int8_int32acc(x, w, b, spec, qw, qa_in, qa_out,
                                         qb, head16=head16)
    else:
        want = golden.conv_w8a16_int32acc(x, w, b, spec, qw, qa_in, qa_out,
                                          qb)
    bias_shifted = golden.shift_round_half_up(
        b.astype(np.int64), np.asarray(qb) - qa_out).astype(np.int32)
    shift_out = qa_in + qw - qa_out
    return {"tier": tier, "cls": cls, "pad": pad, "stride": stride,
            "act": act, "head16": head16,
            "x": x.transpose(1, 2, 0)[None],
            "w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "b": bias_shifted,
            "shift": int(shift_out) if np.ndim(shift_out) == 0
            else shift_out.astype(np.int32),
            "want": want.transpose(1, 2, 0)[None]}


def run_case(case: dict, device) -> np.ndarray:
    """The tier's jax conv on ``device``; returns NHWC numpy."""
    tier, stride, pad, act = (case["tier"], case["stride"], case["pad"],
                              case["act"])
    shift = case["shift"]
    put = lambda a: jax.device_put(jnp.asarray(a), device)  # noqa: E731
    x, w, b = put(case["x"]), put(case["w"]), put(case["b"])
    if tier == "int16":
        fn = jax.jit(lambda x, w, b: convops.conv_int16(
            x, w, b, stride, pad, act, shift))
        return np.asarray(fn(x, w, b))
    if tier == "int8":
        fn = jax.jit(lambda x, w, b: convops.conv_int8(
            x, w, b, stride, pad, act, shift, head16=case["head16"]))
        return np.asarray(fn(x, w, b))
    cw = put(convops.prep_weights_w8a16(case["w"]))
    fn = jax.jit(lambda x, w, cw, b: convops.conv_w8a16(
        x, w, cw, b, stride, pad, act, shift))
    return np.asarray(fn(x, w, cw, b))
