"""int8 and w8a16 tiers: the s8 GEMM route (ops.convops.s8_acc) against
the golden numpy twins, per conv class of the model zoo at real channel
widths, with per-channel requant shifts (and the int8 head16 epilogue on
the linear head convs)."""

import jax
import numpy as np
import pytest

from exact_cases import CLASSES, class_id, make_case, run_case


@pytest.mark.parametrize("tier", ["int8", "w8a16"])
@pytest.mark.parametrize("cls", CLASSES, ids=class_id)
def test_s8_tier_conv_class_matches_golden(tier, cls):
    case = make_case(tier, cls, seed=3)
    got = run_case(case, jax.devices("cpu")[0])
    assert got.dtype == case["want"].dtype
    np.testing.assert_array_equal(got, case["want"])
