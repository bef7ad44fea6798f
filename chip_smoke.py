"""Smoke run of the whole system on one GPU, through its user entry points.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --four-gpus  # four cards: the multi-card phase only

Full YOLOv2 geometry (416x416, 80 classes, 23 convs, reorg + route, region
head) with synthetic weights from --seed. Phases, in order:

  device        card name and power limit (nvidia-smi), JAX version, compile
                cache; fails unless JAX's default device is a GPU
  detect        cli/detect, int16 tier, on examples/demo.png
  int16         Engine(int16): 416^2 heads bit-equal to the same program
                on the CPU; at 96^2 (real widths) bit-equal to the golden
                numpy oracle
  stream        batched uint8 frames of two sizes through the on-device
                letterbox + NMS engine
  tiers         int8, w8a16 and fp32 Engine batches; fp32 head against the
                golden fp32 oracle within a stated tolerance
  card_tests    the card-only tests (pytest marker ``gpu``): per conv class,
                each integer tier bit-equal to its CPU run and numpy twin
  train         a few steps of cli/train --synthetic-data, finite loss

Every phase raises on failure, and a failed phase fails the run: the last
line, printed only when all passed, is one JSON object
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
One process drives the card(s).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NET = 416            # full YOLOv2 input
GOLDEN_NET = 96      # golden numpy oracle size (minutes at 416^2)
FRAME_SIZES = ((480, 640), (720, 1280))
FP32_TOL = 1e-4      # max |head - golden| / max |golden|: summation order


def nvidia_smi() -> str:
    """Card name and power limit, from a subprocess that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def require_gpu(dev) -> None:
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's default device is "
                         f"{dev.platform!r}, not a GPU")


def peak_bytes(dev) -> int | None:
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


def show_memory(label: str, compiled) -> None:
    ma = compiled.memory_analysis()
    sizes = {k: getattr(ma, k, None) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}
    print(f"   memory_analysis[{label}]: {sizes}", flush=True)


def run_phase(name: str, fn, dev) -> None:
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    fn()
    print(f"   {name} ok in {time.perf_counter() - t0:.1f} s, "
          f"peak_bytes_in_use {peak_bytes(dev)}", flush=True)


def synthetic_store(spec, precision: str, seed: int):
    from yolotpu.runtime.engine import load_or_synthesize
    return load_or_synthesize(spec, None, precision, synthetic=True,
                              seed=seed)


def frames(rng, n: int, h: int, w: int) -> np.ndarray:
    return rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def phase_detect(seed: int) -> None:
    from yolotpu.cli import detect
    from yolotpu.image import load_rgb
    out = os.path.join(REPO, "results", "chip_smoke", "demo_prediction")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = detect.main(["--input", os.path.join(REPO, "examples",
                                                  "demo.png"),
                          "--precision", "int16", "--synthetic-weights",
                          "--seed", str(seed), "--thresh", "0.05",
                          "--output", out])
    text = buf.getvalue()
    assert rc == 0, rc
    timing = [l for l in text.splitlines() if "predicted in" in l]
    lines = [l for l in text.splitlines() if re.match(r".+: \d+%$", l)]
    assert timing, text[-2000:]
    print(f"   detect: {timing[0]}")
    print(f"   detect: {len(lines)} labels, e.g. {lines[:5]}")
    img = load_rgb(out + ".png")
    assert img.shape == (576, 768, 3), img.shape
    print(f"   detect: wrote {out}.png {img.shape}")


def phase_int16(seed: int, dev) -> None:
    import jax
    from yolotpu.golden import GoldenNet
    from yolotpu.image import letterbox_image
    from yolotpu.models import yolov2 as m
    from yolotpu.models import zoo
    from yolotpu.runtime.engine import Engine

    spec = zoo.build("yolov2", width=NET, height=NET)
    store = synthetic_store(spec, "int16", seed)
    eng = Engine(spec, store, precision="int16", backend="xla")
    rng = np.random.default_rng(seed)
    x = frames(rng, 2, NET, NET)
    heads = eng.predict_batch_rgb(x)                # (2, 425, 13, 13)
    assert heads.shape == (2, 425, NET // 32, NET // 32), heads.shape
    assert np.isfinite(heads).all()
    show_memory("int16 b2", eng.compile(jax.numpy.asarray(x)))
    # the same program on the CPU, frame 0 (the CPU needs ~a minute)
    cpu = jax.devices("cpu")[0]
    params = jax.device_put(m.params_int16(spec, store), cpu)
    fwd = m.build_forward(spec, "int16", store.qtables, outputs=("head",))
    t0 = time.perf_counter()
    head_cpu = np.asarray(jax.jit(lambda p, v: fwd(p, v)["head"])(
        params, jax.device_put(x[:1], cpu)))[0].transpose(2, 0, 1)
    eq = np.array_equal(heads[0], head_cpu)
    print(f"   int16 {NET}^2 head GPU == CPU: {eq} "
          f"(CPU {time.perf_counter() - t0:.0f} s, "
          f"{int(np.sum(heads[0] != head_cpu))} elements differ)")
    assert eq

    # golden numpy oracle at a reduced input size, every width real
    gspec = zoo.build("yolov2", width=GOLDEN_NET, height=GOLDEN_NET)
    gstore = synthetic_store(gspec, "int16", seed)
    geng = Engine(gspec, gstore, precision="int16", backend="xla")
    img = letterbox_image(
        rng.random((3, 200, 300)).astype(np.float32), GOLDEN_NET, GOLDEN_NET)
    got = geng.predict(img).head_chw
    want = GoldenNet(gspec).forward_int16(img, gstore.int16, gstore.qtables,
                                          mode="int32")[gspec.n - 1]
    eq = np.array_equal(got, want)
    print(f"   int16 {GOLDEN_NET}^2 head == golden int32 mode: {eq}")
    assert eq


def phase_stream(seed: int, dev) -> None:
    from yolotpu.models import zoo
    from yolotpu.runtime.engine import Engine

    spec = zoo.build("yolov2", width=NET, height=NET)
    store = synthetic_store(spec, "int16", seed)
    eng = Engine(spec, store, precision="int16", backend="xla",
                 device_nms=True, thresh=0.05, warmup=False)
    rng = np.random.default_rng(seed + 1)
    for h, w in FRAME_SIZES:
        sb, ss, sc, sv = eng.predict_batch_raw_frames(frames(rng, 3, h, w))
        assert sb.shape[0] == 3 and sb.shape[2] == 4, sb.shape
        assert np.isfinite(sb).all()
        assert np.isfinite(ss).all() and sv.dtype == np.bool_
        dets = [eng.detections_from_topk(sb[i], ss[i], sc[i], sv[i], w, h)
                for i in range(3)]
        print(f"   stream {h}x{w} b3: detections per frame "
              f"{[len(d) for d in dets]}")


def phase_tiers(seed: int, dev) -> None:
    import jax
    from yolotpu.golden import GoldenNet
    from yolotpu.models import zoo
    from yolotpu.runtime.engine import Engine

    spec = zoo.build("yolov2", width=NET, height=NET)
    rng = np.random.default_rng(seed + 2)
    x = frames(rng, 2, NET, NET)
    for tier in ("int8", "w8a16", "fp32"):
        store = synthetic_store(spec, tier, seed)
        eng = Engine(spec, store, precision=tier, backend="xla",
                     warmup=False)
        heads = eng.predict_batch_rgb(x)
        assert heads.shape == (2, 425, NET // 32, NET // 32), heads.shape
        assert np.isfinite(heads).all()
        show_memory(f"{tier} b2", eng.compile(jax.numpy.asarray(x)))
        print(f"   {tier}: head |max| {np.abs(heads).max():.4f}")
        if tier == "fp32":
            img = x[0].astype(np.float32).transpose(2, 0, 1) / 255.0
            want = GoldenNet(spec).forward_fp32(img, store.fp32)[spec.n - 1]
            err = np.abs(heads[0] - want)
            scale = float(np.abs(want).max())
            print(f"   fp32 vs golden: max abs {err.max():.3e}, "
                  f"max abs / max|golden| {err.max() / scale:.3e} "
                  f"(tolerance {FP32_TOL}: summation order on the card)")
            assert err.max() <= FP32_TOL * scale


def phase_card_tests() -> None:
    import pytest

    class Count:
        def __init__(self):
            self.n = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.n[report.outcome] += 1

    os.environ["YOLO2_TEST_ON_GPU"] = "1"
    count = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(REPO, "tests", "test_gpu.py")],
                     plugins=[count])
    print(f"   card tests: {count.n} (pytest exit {rc})")
    assert rc == 0 and count.n["failed"] == count.n["skipped"] == 0 \
        and count.n["passed"] > 0, (rc, count.n)


def train_losses(argv: list[str]) -> list[float]:
    from yolotpu.cli import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    assert rc == 0, rc
    print("   " + buf.getvalue().strip().replace("\n", "\n   "))
    return [float(v) for v in re.findall(r"loss (\S+)", buf.getvalue())]


def phase_train(seed: int) -> None:
    ck = os.path.join(REPO, "results", "chip_smoke", "ckpt")
    losses = train_losses(["--synthetic-data", "--steps", "3", "--batch", "4",
                           "--seed", str(seed), "--ckpt-dir", ck,
                           "--ckpt-every", "0"])
    assert len(losses) >= 2 and np.isfinite(losses).all(), losses


# ---------------------------------------------------------------------------
# four-card phase
# ---------------------------------------------------------------------------

def phase_four(seed: int, n: int) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from yolotpu.models import yolov2 as m
    from yolotpu.models import zoo
    from yolotpu.parallel import mesh as pmesh
    from yolotpu.cli.train import synthetic_batch
    from yolotpu.train import make_train_step, zeros_like_velocity
    from yolotpu.weights import WeightStore

    devs = jax.devices()
    assert len(devs) >= n, devs
    spec = zoo.build("yolov2", width=NET, height=NET)
    rng = np.random.default_rng(seed)

    # dp=n training step vs one card: same loss up to summation order
    store = WeightStore.synthetic(spec, seed=seed)
    params = m.params_fp32(spec, store)
    batch = {k: jnp.asarray(v)
             for k, v in synthetic_batch(spec, rng, 2 * n).items()}
    one = jax.jit(make_train_step(spec))
    _, _, loss1 = one(params, zeros_like_velocity(params), batch)
    dp_mesh = jax.sharding.Mesh(np.array(devs[:n]).reshape(n, 1),
                                ("dp", "tp"))
    put = lambda t, s: jax.device_put(t, s)  # noqa: E731
    bsh = {k: NamedSharding(dp_mesh, P("dp", *([None] * (v.ndim - 1))))
           for k, v in batch.items()}
    stepn = jax.jit(make_train_step(spec, mesh=dp_mesh))
    _, _, lossn = stepn(put(params, NamedSharding(dp_mesh, P())),
                        put(zeros_like_velocity(params),
                            NamedSharding(dp_mesh, P())),
                        {k: put(v, bsh[k]) for k, v in batch.items()})
    l1, ln = float(loss1), float(lossn)
    rel = abs(l1 - ln) / abs(l1)
    print(f"   train dp={n}: loss {ln:.6f} vs one card {l1:.6f} "
          f"(rel {rel:.2e}, tolerance 1e-4: summation order)")
    assert np.isfinite(ln) and rel <= 1e-4

    # dp-sharded int16 inference at 416^2: bit-equal to one card
    from yolotpu.quant import calibrate_activations, quantize_weights
    quantize_weights(store, calibrate_activations(
        spec, store, [rng.random((3, NET, NET), dtype=np.float32)]))
    iparams = m.params_int16(spec, store)
    fwd = m.build_forward(spec, "int16", store.qtables, outputs=("head",))
    x = frames(rng, 2 * n, NET, NET)
    fn = jax.jit(lambda p, v: fwd(p, v)["head"])
    want = np.asarray(fn(iparams, jnp.asarray(x)))
    got = np.asarray(fn(put(iparams, NamedSharding(dp_mesh, P())),
                        put(x, NamedSharding(dp_mesh, P("dp")))))
    eq = np.array_equal(got, want)
    print(f"   int16 {NET}^2 dp={n} head == one card: {eq}")
    assert eq

    # the mesh cli/train --mesh builds at n cards
    dp, tp = pmesh.factor_mesh(n)
    print(f"   cli/train --mesh at n={n}: dp={dp} x tp={tp}")
    ck = os.path.join(REPO, "results", "chip_smoke", "ckpt_mesh")
    args = ["--synthetic-data", "--steps", "2", "--batch", "4", "--seed",
            str(seed), "--ckpt-every", "0"]
    l_mesh = train_losses(args + ["--mesh", "--ckpt-dir", ck])
    l_one = train_losses(args + ["--ckpt-dir", ck + "_one"])
    rel = abs(l_mesh[0] - l_one[0]) / abs(l_one[0])
    print(f"   cli/train --mesh step-0 loss {l_mesh[0]} vs one card "
          f"{l_one[0]} (rel {rel:.2e})")
    assert np.isfinite(l_mesh).all() and rel <= 1e-4


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("YOLO2_NO_DUMP", "1")

    import jax
    from yolotpu.compile_cache import configure as configure_compile_cache

    dev = jax.devices()[0]

    def phase_device():
        print(nvidia_smi())      # as nvidia-smi prints it, one line a card
        print(f"   jax {jax.__version__}, devices {jax.devices()}")
        print(f"   compile cache: {configure_compile_cache()}")
        require_gpu(dev)

    run_phase("device", phase_device, dev)
    if args.four_gpus:
        run_phase("four_gpus", lambda: phase_four(args.seed, 4), dev)
    else:
        run_phase("detect", lambda: phase_detect(args.seed), dev)
        run_phase("int16", lambda: phase_int16(args.seed, dev), dev)
        run_phase("stream", lambda: phase_stream(args.seed, dev), dev)
        run_phase("tiers", lambda: phase_tiers(args.seed, dev), dev)
        run_phase("card_tests", phase_card_tests, dev)
        run_phase("train", lambda: phase_train(args.seed), dev)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
