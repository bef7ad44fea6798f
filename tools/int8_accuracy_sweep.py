"""int8 tier accuracy diagnosis at flagship depth (CPU, ~25 min).

Trains the full yolov2 graph at 128x128 on synthetic scenes ONCE (same
recipe as tests/test_accuracy_flagship.py), then evaluates the w8a8 tier
across quantization recipes: activation margin x per-channel weights.
Prints one JSON line per config. Evidence feeding the int8 defaults in
quant.py (per-channel weight scales; activation margin).

Usage: JAX_PLATFORMS=cpu python tools/int8_accuracy_sweep.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CPU-only sweep: it never takes the accelerator from other work.
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402
assert jax.default_backend() == "cpu", jax.default_backend()


def main() -> int:
    import jax
    from yolotpu import eval as yeval
    from yolotpu.image import load_image
    from yolotpu.models import yolov2 as m
    from yolotpu.models import zoo
    from yolotpu.quant import (calibrate_activations, quantize_weights,
                               quantize_weights_int8)
    from yolotpu.runtime.engine import Engine
    from yolotpu.train import LossConfig, make_train_step, zeros_like_velocity
    from yolotpu.weights import WeightStore

    S = 128
    CLASS_COLORS = {0: (210, 40, 40), 1: (40, 60, 210)}
    rng = np.random.default_rng(0)

    def make_scene(r, w=S, h=S, n_obj=2):
        img = np.full((h, w, 3), 128, np.uint8)
        img += r.integers(-8, 8, img.shape).astype(np.uint8)
        boxes, classes = [], []
        for _ in range(n_obj):
            cls = int(r.integers(0, 2))
            bw, bh = int(r.integers(40, 64)), int(r.integers(40, 64))
            x0 = int(r.integers(2, w - bw - 2))
            y0 = int(r.integers(2, h - bh - 2))
            img[y0:y0 + bh, x0:x0 + bw] = CLASS_COLORS[cls]
            boxes.append(((x0 + bw / 2) / w, (y0 + bh / 2) / h, bw / w, bh / h))
            classes.append(cls)
        return img, np.asarray(boxes, np.float32), np.asarray(classes, np.int32)

    spec = zoo.build("yolov2", width=S, height=S)
    scenes = [make_scene(rng) for _ in range(24)]
    MB = 8

    def batch_from(idxs):
        B = len(idxs)
        imgs = np.zeros((B, S, S, 3), np.float32)
        bx = np.zeros((B, MB, 4), np.float32)
        cl = np.zeros((B, MB), np.int32)
        mk = np.zeros((B, MB), np.float32)
        for k, i in enumerate(idxs):
            img, boxes, classes = scenes[i]
            imgs[k] = img.astype(np.float32) / 255.0
            n = len(classes)
            bx[k, :n], cl[k, :n], mk[k, :n] = boxes, classes, 1.0
        return {"images": imgs, "boxes": bx, "classes": cl, "mask": mk}

    cache = os.environ.get("INT8_SWEEP_STORE", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "results", "int8_sweep_store.npz"))
    store = WeightStore(spec=spec)
    if os.path.exists(cache):
        z = np.load(cache)
        for l in spec.conv_layers():
            store.fp32[l.idx] = (z[f"w{l.idx}"], z[f"b{l.idx}"])
        print(f"# loaded trained weights from {cache}", flush=True)
    else:
        store0 = WeightStore.synthetic(spec, seed=3)
        params = m.params_fp32(spec, store0)
        step = jax.jit(make_train_step(spec, lr=2e-4, momentum=0.9,
                                       cfg=LossConfig(rescore=False),
                                       clip_norm=1.0))
        vel = zeros_like_velocity(params)
        order = np.arange(24)
        for it in range(400):
            rng.shuffle(order)
            params, vel, loss = step(params, vel, batch_from(order[:4]))
            if it % 100 == 0:
                print(f"# train it={it} loss={float(loss):.3f}", flush=True)
        for l in spec.conv_layers():
            p = params[f"conv{l.idx}"]
            store.fp32[l.idx] = (
                np.ascontiguousarray(
                    np.asarray(p["w"]).transpose(3, 2, 0, 1),
                    dtype=np.float32),
                np.asarray(p["b"], np.float32))
        os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
        np.savez(cache, **{f"w{i}": w for i, (w, _) in store.fp32.items()},
                 **{f"b{i}": b for i, (_, b) in store.fp32.items()})
        print(f"# saved trained weights to {cache}", flush=True)

    from PIL import Image
    out_dir = tempfile.mkdtemp(prefix="int8sweep")
    eval_rng = np.random.default_rng(99)
    pairs = []
    # 16 eval scenes: at 6 the per-config mAP deltas were inside the noise
    # (per-channel w8a8 flipped sign between runs — see STATUS round 4)
    for i in range(int(os.environ.get("INT8_SWEEP_EVAL_N", "16"))):
        img, boxes, classes = make_scene(eval_rng)
        ip = os.path.join(out_dir, f"eval{i}.png")
        lp = os.path.join(out_dir, f"eval{i}.txt")
        Image.fromarray(img).save(ip)
        with open(lp, "w") as f:
            for b, c in zip(boxes, classes):
                f.write(f"{c} {b[0]} {b[1]} {b[2]} {b[3]}\n")
        pairs.append((ip, lp))

    calib = [np.full((3, S, S), 0.5, np.float32), load_image(pairs[0][0])]

    eng32 = Engine(spec, store, precision="fp32", backend="xla")
    r32 = yeval.evaluate_engine(eng32, pairs, num_classes=80, thresh=0.05)
    print(json.dumps({"cfg": "fp32", "mAP_50": r32["mAP_50"]}), flush=True)

    act_q16 = calibrate_activations(spec, store, calib)   # margin 2.0
    quantize_weights(store, act_q16)
    eng16 = Engine(spec, store, precision="int16", backend="xla")
    r16 = yeval.evaluate_engine(eng16, pairs, num_classes=80, thresh=0.05)
    print(json.dumps({"cfg": "int16", "mAP_50": r16["mAP_50"]}), flush=True)

    from yolotpu.quant import quantize_weights_w8a16
    quantize_weights_w8a16(store, act_q16)
    engw8 = Engine(spec, store, precision="w8a16", backend="xla")
    rw8 = yeval.evaluate_engine(engw8, pairs, num_classes=80, thresh=0.05)
    print(json.dumps({"cfg": "w8a16", "mAP_50": rw8["mAP_50"]}), flush=True)

    for margin in (2.0, 1.4, 1.0):
        act_q16m = calibrate_activations(spec, store, calib, margin=margin)
        act_q8 = [q - 8 for q in act_q16m]
        for pc in (False, True):
            quantize_weights_int8(store, act_q8, per_channel=pc)
            eng8 = Engine(spec, store, precision="int8", backend="xla")
            r8 = yeval.evaluate_engine(eng8, pairs, num_classes=80,
                                       thresh=0.05)
            print(json.dumps({"cfg": f"int8 margin={margin} pc={pc}",
                              "mAP_50": r8["mAP_50"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
