"""Card-only tests (marker ``gpu``): the exact integer routes as XLA
compiles them for the GPU, per conv class of the model zoo at real channel
widths — each tier's GPU result bit-equal to the same jitted conv on the
CPU and to its numpy twin — and the fp32 conv held to true fp32 (not TF32)
on the card. They skip without a GPU; ``chip_smoke.py`` runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exact_cases import CLASSES, TIERS, class_id, make_case, run_case
from yolotpu.ops import convops

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cls", CLASSES, ids=class_id)
def test_integer_tiers_on_gpu_equal_cpu_and_twin(gpu_device, cls):
    cpu = jax.devices("cpu")[0]
    for tier in TIERS:
        case = make_case(tier, cls, seed=5)
        got = run_case(case, gpu_device)
        np.testing.assert_array_equal(got, run_case(case, cpu),
                                      err_msg=f"{tier} GPU != CPU")
        np.testing.assert_array_equal(got, case["want"],
                                      err_msg=f"{tier} GPU != numpy twin")


def test_fp32_conv_is_true_fp32_on_gpu(gpu_device):
    """conv_fp32's HIGHEST precision on the card: relative error against
    an f64 reference at the f32 rounding level (TF32 would be ~1e-3)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 512)).astype(np.float32)
    w = rng.standard_normal((3, 3, 512, 64)).astype(np.float32)
    b = np.zeros(64, np.float32)
    got = np.asarray(jax.jit(lambda x, w, b: convops.conv_fp32(
        x, w, b, 1, 1, "linear"))(*(jax.device_put(jnp.asarray(a), gpu_device)
                                    for a in (x, w, b))))
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = sum(xp[:, dy:dy + 8, dx:dx + 8, :] @ w[dy, dx].astype(np.float64)
               for dy in range(3) for dx in range(3))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-5, err
