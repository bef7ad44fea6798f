"""Whole-graph forward per tier through the user-facing Engine: yolov2 at a
32x32 input (every channel width real, 1x1 region grid, all five pools and
the reorg/route branch exercised) against the golden numpy backend —
bit-equal for the integer tiers, within f32 rounding for fp32."""

import numpy as np
import pytest

from yolotpu.image import letterbox_image
from yolotpu.models import zoo
from yolotpu.runtime.engine import Engine, load_or_synthesize


@pytest.mark.parametrize("tier", ["int16", "int8", "w8a16", "fp32"])
def test_engine_forward_matches_golden(tier):
    spec = zoo.build("yolov2", width=32, height=32)
    store = load_or_synthesize(spec, None, tier, synthetic=True, seed=2)
    img = letterbox_image(np.random.default_rng(2).random(
        (3, 40, 56)).astype(np.float32), 32, 32)
    got = Engine(spec, store, precision=tier, backend="xla",
                 warmup=False).predict(img).head_chw
    want = Engine(spec, store, precision=tier,
                  backend="golden").predict(img).head_chw
    assert got.shape == want.shape == (425, 1, 1)
    if tier == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)
