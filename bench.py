"""Headline benchmark: YOLOv2 416x416 end-to-end throughput on one GPU.

Prints ONE JSON line:
  {"metric": "yolov2_416_int16_fps", "value": N, "unit": "frames/sec",
   "vs_baseline": N / 0.1, "int8_serving_fps": M, ..., "device": {...}}

Baseline: the reference FPGA stack's known-good end-to-end throughput is
~0.1 FPS on the KV260 (reference HLS_OPTIMIZATION_TASKLIST.md:3-4; see
BASELINE.md). Measurement mirrors its method — mean over repeated timed
inferences of the full network (input quantization -> 32 layers -> region
head) — with batched steps, each timed up to ``block_until_ready``.

Tiers (one bench construction, per-tier params/forward):
  int16  — the reference's precision, exact int32-accumulation semantics
           (bit-exact vs the compiled reference binary): the PRIMARY metric.
  int8   — the w8a8 serving tier (s8 GEMMs, 16-bit detection-head logits),
           reported as a secondary key in the same JSON line.
  w8a16 / fp32 — measurable via BENCH_PRECISION.

The run fails (exit != 0, no JSON line) when JAX finds no GPU or when any
tier fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_FPS = 0.1
BATCH = int(os.environ.get("BENCH_BATCH", "128"))
STEPS = int(os.environ.get("BENCH_STEPS", "10"))
MODEL = os.environ.get("BENCH_MODEL", "yolov2")
# BENCH_PRECISION restricts the run to ONE tier (experiments); the default
# "" measures the official int16 headline plus the int8 serving tier
PRECISION = os.environ.get("BENCH_PRECISION", "")


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    import jax
    from yolotpu.compile_cache import configure as configure_compile_cache
    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    print(f"# {gpu_name_and_power_limit()}", file=sys.stderr, flush=True)
    import jax.numpy as jnp

    from yolotpu.models import yolov2 as m
    from yolotpu.models import zoo
    from yolotpu.quant import (calibrate_activations,
                               calibrate_activations_int8, quantize_weights,
                               quantize_weights_int8)
    from yolotpu.weights import WeightStore

    # BENCH_WIDTH/HEIGHT: smoke-test the bench path at a reduced size; the
    # official metric is the default 416
    bw = os.environ.get("BENCH_WIDTH")
    bh = os.environ.get("BENCH_HEIGHT")
    spec = zoo.build(MODEL, width=int(bw) if bw else None,
                     height=int(bh) if bh else None)
    store = WeightStore.synthetic(spec, seed=0)
    rng = np.random.default_rng(0)
    calib = [rng.random((3, spec.net.height, spec.net.width),
                        dtype=np.float32)]
    act_q = calibrate_activations(spec, store, calib)
    quantize_weights(store, act_q)

    def build(precision):
        if precision == "fp32":
            # the reference's own `--precision fp32` tier, true fp32
            # (conv_fp32 defaults to HIGHEST precision)
            return m.params_fp32(spec, store), m.build_forward(
                spec, "fp32", outputs=("head", "boxes"))
        if precision == "int8":
            quantize_weights_int8(
                store, calibrate_activations_int8(spec, store, calib))
            return m.params_int8(spec, store), m.build_forward(
                spec, "int8", store.qtables8, outputs=("head", "boxes"))
        if precision == "w8a16":
            from yolotpu.quant import quantize_weights_w8a16
            quantize_weights_w8a16(store, store.qtables.act_q)
            return m.params_w8a16(spec, store), m.build_forward(
                spec, "w8a16", store.qtables_w8, outputs=("head", "boxes"))
        assert precision == "int16", precision
        return m.params_int16(spec, store), m.build_forward(
            spec, "int16", store.qtables, outputs=("head", "boxes"))

    # uint8 frames: what a camera/decoder hands over; on-device /255 is
    # bit-identical to the host loader's float division
    # (yolo2_image_loader.c:34-80)
    base = rng.integers(0, 256, (BATCH, spec.net.height, spec.net.width, 3)
                        ).astype(np.uint8)

    def measure(precision):
        params, fwd = build(precision)
        fn = jax.jit(lambda p, x: fwd(p, x)["obj"])
        x = jax.device_put(base)
        jax.block_until_ready(fn(params, x))          # compile + warm
        times = []
        for _rep in range(STEPS):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(params, x))
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        print(f"# bench[{precision}] ms_per_step={med * 1e3:.3f} "
              f"batch={BATCH} steps={STEPS}", file=sys.stderr, flush=True)
        return med

    def measure_b1(precision):
        """Single-frame latency: p50/p90 over timed batch-1 steps."""
        params, fwd = build(precision)
        fn = jax.jit(lambda p, x: fwd(p, x)["obj"])
        x1 = jax.device_put(base[:1])
        jax.block_until_ready(fn(params, x1))         # compile + warm
        ts = []
        for _rep in range(50):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(params, x1))
            ts.append((time.perf_counter() - t0) * 1e3)
        return (float(np.percentile(ts, 50)), float(np.percentile(ts, 90)))

    def accuracy_evidence(tier):
        """Measured mAP evidence for a tier from plans/accuracy_<tier>.json
        (written by tools/accuracy_protocol.py). None when absent or stale
        — bench never asserts an accuracy it did not inherit from a
        recorded measurement."""
        from yolotpu.accuracy import protocol_hash
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "plans", f"accuracy_{tier}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            doc = json.load(f)
        if (doc.get("protocol_hash") != protocol_hash()
                or doc.get("resolution") != spec.net.width):
            return None
        return doc

    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if PRECISION:                       # single-tier experiment run
        fps = BATCH / measure(PRECISION)
        print(json.dumps({
            "metric": f"{MODEL}_{spec.net.width}_{PRECISION}_fps",
            "value": fps, "unit": "frames/sec",
            "vs_baseline": fps / BASELINE_FPS, "device": device}))
        return 0

    # official run: the int16 headline (the reference's precision,
    # bit-exact semantics) + the int8 serving tier in the same JSON line
    med16 = measure("int16")
    rec = {
        "metric": f"{MODEL}_{spec.net.width}_int16_fps",
        "value": BATCH / med16,
        "unit": "frames/sec",
        "vs_baseline": BATCH / med16 / BASELINE_FPS,
    }
    rec["p50_ms_b1"], rec["p90_ms_b1"] = measure_b1("int16")
    ev16 = accuracy_evidence("int16")
    if ev16:
        rec["int16_mAP_delta_vs_fp32"] = ev16["delta_vs_fp32_mean"]
    med8 = measure("int8")
    rec["int8_serving_fps"] = BATCH / med8
    rec["int8_serving_ms_per_step"] = med8 * 1e3
    ev8 = accuracy_evidence("int8")
    if ev8:
        rec["int8_serving_mAP_delta_vs_fp32"] = ev8["delta_vs_fp32_mean"]
        rec["int8_serving_mAP_ci95"] = ev8["delta_vs_fp32_ci95"]
    rec["device"] = device
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
