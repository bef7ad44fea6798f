"""Device sanity checks: the board bring-up tests, accelerator edition.

The reference ships small board binaries (``linux_app/tests/README.md:1-29``):
``test_accel`` (register liveness + write/readback), ``test_dma`` (udmabuf
alloc + phys addr), ``test_pl_ddr`` (PL<->DDR path), ``check_hp_clocks``.
Their equivalents here, runnable before any model work:

  enumerate   device table (kind, platform, memory stats when exposed)
  alloc       device allocate + write/readback integrity (test_dma analog)
  compute     small matmuls vs numpy (register/datapath liveness analog)
  bandwidth   host->device and device->host transfer rates (test_pl_ddr
              analog)
  latency     dispatch + block_until_ready roundtrip

Exit code 0 iff every check passes.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def check_enumerate() -> bool:
    import jax
    devs = jax.devices()
    print(f"  platform={jax.default_backend()} devices={len(devs)}")
    for d in devs:
        print(f"    [{d.id}] {d.device_kind} (process {d.process_index})")
        try:
            ms = d.memory_stats()
            if ms:
                lim = ms.get("bytes_limit")
                use = ms.get("bytes_in_use")
                if lim:
                    print(f"         {use / 1e9:.2f} / {lim / 1e9:.2f} GB in use")
        except Exception:
            pass
    return len(devs) > 0


def check_alloc(mb: int = 256) -> bool:
    import jax.numpy as jnp
    n = mb * 1024 * 1024 // 4
    rng = np.random.default_rng(0)
    host = rng.integers(0, 2**31 - 1, n, np.int32)
    dev = jnp.asarray(host)
    back = np.asarray(dev)
    ok = np.array_equal(host, back)
    print(f"  {mb} MiB write/readback: {'OK' if ok else 'MISMATCH'}")
    return ok


def check_compute() -> bool:
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    got = np.asarray(jax.jit(
        lambda a, b: jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST))(
            jnp.asarray(a), jnp.asarray(b)))
    want = a @ b
    err = np.abs(got - want).max() / max(1e-9, np.abs(want).max())
    ok = err < 1e-5
    print(f"  256x256 matmul vs numpy: rel err {err:.2e} {'OK' if ok else 'FAIL'}")
    # integer datapath liveness: the s8 x s8 -> s32 GEMM every integer
    # tier accumulates on (ops.convops.s8_acc)
    ai = rng.integers(-128, 128, (128, 128)).astype(np.int8)
    bi = rng.integers(-128, 128, (128, 128)).astype(np.int8)
    gi = np.asarray(jax.jit(
        lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.int32))(
            jnp.asarray(ai), jnp.asarray(bi)))
    ok2 = np.array_equal(gi, ai.astype(np.int64) @ bi.astype(np.int64))
    print(f"  128x128 int8xint8->int32 exactness: {'OK' if ok2 else 'FAIL'}")
    return ok and ok2


def check_bandwidth(mb: int = 128) -> bool:
    import jax
    import jax.numpy as jnp
    n = mb * 1024 * 1024 // 4
    host = np.ones(n, np.float32)
    t0 = time.perf_counter()
    dev = jax.block_until_ready(jnp.asarray(host))
    up = mb / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    _ = np.asarray(dev)
    down = mb / (time.perf_counter() - t0)
    print(f"  host->device {up:.0f} MB/s, device->host {down:.0f} MB/s ({mb} MiB)")
    return True


def check_latency() -> bool:
    import jax
    import jax.numpy as jnp
    f = jax.jit(lambda v: v + 1.0)
    v = jnp.float32(0)
    jax.block_until_ready(f(v))
    ts = []
    for _i in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(f(v))
        ts.append(time.perf_counter() - t0)
    print(f"  dispatch+sync roundtrip: p50 {np.median(ts) * 1e3:.2f} ms "
          f"min {min(ts) * 1e3:.2f} ms")
    return True


CHECKS = {
    "enumerate": check_enumerate,
    "alloc": check_alloc,
    "compute": check_compute,
    "bandwidth": check_bandwidth,
    "latency": check_latency,
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="device_check", description=__doc__)
    ap.add_argument("checks", nargs="*", default=list(CHECKS),
                    choices=list(CHECKS) + [[]], help="subset to run")
    args = ap.parse_args(argv)
    names = args.checks or list(CHECKS)
    ok = True
    for name in names:
        print(f"[{name}]")
        try:
            ok &= bool(CHECKS[name]())
        except Exception as e:
            print(f"  EXCEPTION: {e}")
            ok = False
    print("ALL OK" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
