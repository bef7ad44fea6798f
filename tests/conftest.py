"""Test configuration: force JAX onto a virtual 8-device CPU mesh so
sharding/parallelism tests run without accelerator hardware, and keep
everything deterministic.

Fast/slow split: tests marked ``@pytest.mark.slow`` (full-net golden runs,
the 500-step training fixture, reference-binary builds) are DESELECTED by
default so a plain ``pytest -q tests/`` stays quick. Run them with
``--slow`` or ``YOLO2_RUN_SLOW=1`` (CI / pre-release); both suites must
stay green.

Card-only tests carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them unless JAX's default device is a GPU. They run on
the card from ``chip_smoke.py``, which sets ``YOLO2_TEST_ON_GPU=1`` so that
this file leaves JAX's platform alone."""

import os
import sys

import pytest

# Force CPU (a virtual 8-device mesh) unless the card run asked for the GPU.
# The platform is forced in jax's config as well as in the environment, in
# case jax was imported before this file. CPU f32 convs are exact f32,
# which the f32 parity tests rely on.
ON_GPU = os.environ.get("YOLO2_TEST_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    import jax._src.api as _jax_api  # noqa: E402
    jax.config.update("jax_platforms", "cpu")
    _jax_api.clear_backends()
    assert jax.default_backend() == "cpu", jax.default_backend()
    # CLIs under test point the persistent compile cache into the
    # checkout; CPU test programs are not worth keeping there
    jax.config.update("jax_enable_compilation_cache", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def pytest_addoption(parser):
    parser.addoption("--slow", action="store_true", default=False,
                     help="also run tests marked slow")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: expensive test (full-net golden run, long "
        "training, reference-binary build); excluded by default")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (gpu_device fixture); run on the card "
        "by chip_smoke.py, skipped elsewhere")


@pytest.fixture
def gpu_device():
    """The GPU the card-only tests run on; skips when there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX default device is {dev.platform}); "
                    "run on the card by chip_smoke.py")
    return dev


def pytest_collection_modifyitems(config, items):
    if config.getoption("--slow") or os.environ.get("YOLO2_RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(
        reason="slow (use --slow or YOLO2_RUN_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


REFERENCE_DIR = "/root/reference"


def reference_path(*parts: str) -> str | None:
    """Path into the read-only reference checkout, if it exists (used only to
    cross-validate against upstream data files like cfgs/test images)."""
    p = os.path.join(REFERENCE_DIR, *parts)
    return p if os.path.exists(p) else None
