"""Flagship-depth accuracy on protocol v2: machinery on CPU, criterion by
committed evidence.

Protocol v2 (yolotpu/accuracy.py — VERDICT r4 #2): 8 classes, 512 train /
64 held-out eval scenes, object scale/aspect/occlusion diversity. The
round-4 protocol (16 scenes, 2 classes, train==eval) was noise-dominated —
a quantized tier "beat" fp32 by +0.16 mAP; and its 64-train-scene successor
memorized (TRAIN-scene mAP 0.9755 vs EVAL 0.0068, measured r5).

Two layers of assertion:

1. ``test_flagship_*`` (slow, CPU): trains the FULL 23-conv graph a short
   budget and asserts the MACHINERY — loss decreases at depth, every
   quantized tier stays within the 0.1-mAP criterion of fp32 AND the
   ordering fp32 >= tier - EPS holds (the r4 inversion must be impossible
   at any mAP level). No absolute-mAP bar here: held-out mAP needs the
   protocol-strength budget (8000 steps at 416²), which belongs to the
   GPU evidence run, not a CPU test.

2. ``test_accuracy_evidence_files`` (fast): the committed
   ``plans/accuracy_<tier>.json`` evidence (written by
   tools/accuracy_protocol.py at 416²) must exist, carry the
   CURRENT protocol hash (stale evidence fails the suite, it doesn't
   silently ship), reach non-noise fp32 mAP, and satisfy criterion +
   ordering per tier. This is the enforcement point for BASELINE.md's
   "mAP within 0.1 of fp32".
"""

import json
import os

import numpy as np
import pytest

from yolotpu import accuracy as acc
from yolotpu import eval as yeval
from yolotpu.models import zoo
from yolotpu.quant import calibrate_activations, quantize_weights
from yolotpu.runtime.engine import Engine

S = 128
EPS = 0.03           # ordering slack: small vs the 0.1 criterion
PLANS = os.path.join(os.path.dirname(__file__), os.pardir, "plans")


@pytest.fixture(scope="module")
def trained_flagship(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("flag")
    spec = zoo.build("yolov2", width=S, height=S)
    store, losses = acc.train_flagship_store(spec, seed=0, size=S,
                                             steps=400, batch=4)
    assert np.isfinite(losses[-1]), losses
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    pairs = acc.write_eval_set(str(out_dir / "eval"), S)
    assert len(pairs) == acc.PROTOCOL["eval_scenes"] == 64
    return spec, store, pairs


def _quantize(spec, store):
    act_q = calibrate_activations(spec, store, acc.calib_images(S))
    quantize_weights(store, act_q)


@pytest.mark.slow
def test_flagship_int16_within_criterion(trained_flagship):
    spec, store, pairs = trained_flagship
    eng32 = Engine(spec, store, precision="fp32", backend="xla")
    r32 = yeval.evaluate_engine(eng32, pairs, num_classes=80, thresh=0.05)
    assert r32["images"] == 64

    _quantize(spec, store)
    eng16 = Engine(spec, store, precision="int16", backend="xla")
    r16 = yeval.evaluate_engine(eng16, pairs, num_classes=80, thresh=0.05)
    # BASELINE criterion at flagship depth: int16 within 0.1 mAP of fp32
    assert abs(r32["mAP_50"] - r16["mAP_50"]) <= 0.1, (r32, r16)
    # ordering: the quantized tier must not beat its own oracle by more
    # than protocol noise (the r4 inversion must be impossible)
    assert r32["mAP_50"] >= r16["mAP_50"] - EPS, (r32, r16)


@pytest.mark.slow
def test_flagship_w8a16_and_int8_within_criterion(trained_flagship):
    """8-bit tiers at flagship depth, protocol v2: both meet the 0.1-mAP
    criterion AND the ordering (fp32 >= tier - EPS)."""
    from yolotpu.quant import (calibrate_activations_int8,
                               quantize_weights_int8, quantize_weights_w8a16)
    spec, store, pairs = trained_flagship
    _quantize(spec, store)

    eng32 = Engine(spec, store, precision="fp32", backend="xla")
    r32 = yeval.evaluate_engine(eng32, pairs, num_classes=80, thresh=0.05)

    quantize_weights_w8a16(store, store.qtables.act_q)
    eng_w8 = Engine(spec, store, precision="w8a16", backend="xla")
    r_w8 = yeval.evaluate_engine(eng_w8, pairs, num_classes=80, thresh=0.05)
    assert r_w8["mAP_50"] >= r32["mAP_50"] - 0.1, (r32, r_w8)
    assert r32["mAP_50"] >= r_w8["mAP_50"] - EPS, (r32, r_w8)

    calib = acc.calib_images(S)
    act_q8 = calibrate_activations_int8(spec, store, calib)
    quantize_weights_int8(store, act_q8)
    eng8 = Engine(spec, store, precision="int8", backend="xla")
    r8 = yeval.evaluate_engine(eng8, pairs, num_classes=80, thresh=0.05)
    assert r8["mAP_50"] >= r32["mAP_50"] - 0.1, (r32, r8)
    assert r32["mAP_50"] >= r8["mAP_50"] - EPS, (r32, r8)


# ---------------------------------------------------------------------------
# Committed-evidence enforcement (fast suite)
# ---------------------------------------------------------------------------

EVIDENCE_TIERS = ("fp32", "int16", "int8", "w8a16")


def _load_evidence(tier):
    path = os.path.join(PLANS, f"accuracy_{tier}.json")
    assert os.path.exists(path), (
        f"missing accuracy evidence {path} — run tools/accuracy_protocol.py "
        f"on the GPU at 416² after any protocol change")
    with open(path) as f:
        return json.load(f)


def test_accuracy_evidence_files():
    """plans/accuracy_<tier>.json: fresh (current protocol hash), at the
    bench resolution, multi-seed, non-noise fp32 mAP, criterion + ordering
    per quantized tier. bench.py consumes the same files (it drops stale
    ones); this test makes staleness a FAILURE so it cannot ship silently."""
    docs = {t: _load_evidence(t) for t in EVIDENCE_TIERS}
    h = acc.protocol_hash()
    for t, d in docs.items():
        assert d["protocol_hash"] == h, (
            f"{t} evidence is stale: protocol hash {d['protocol_hash']} != "
            f"current {h} — rerun tools/accuracy_protocol.py")
        assert d["resolution"] == 416, d
        assert d["train"]["seeds"] >= 3, d
        assert len(d["mAP_50_per_seed"]) == d["train"]["seeds"], d
    # the protocol must resolve real detection quality, not noise
    assert docs["fp32"]["mAP_50_mean"] >= 0.3, docs["fp32"]
    for t in ("int16", "int8", "w8a16"):
        d = docs[t]
        # BASELINE criterion: tier within 0.1 mAP of fp32 (per-seed mean)
        assert abs(d["delta_vs_fp32_mean"]) <= 0.1, (t, d)
        # ordering: a tier materially beating its own fp32 oracle means
        # the protocol is measuring noise (the r4 inversion)
        assert d["delta_vs_fp32_mean"] <= EPS, (t, d)
