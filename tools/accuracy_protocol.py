"""Accuracy evidence run: protocol v2, >=3 seeds, mean +/- CI95, per tier.

Trains the FULL yolov2 graph on protocol-v2 scenes (yolotpu/accuracy.py:
8 classes, 64 train + 64 eval scenes, scale/aspect/occlusion diversity)
for N seeds, evaluates every tier at the target resolution WITH THE SAME
ENGINE CONFIGURATION the bench measures (compute='int32'), and
writes ``plans/accuracy_<tier>.json`` evidence files that bench.py reads
instead of asserting a hardcoded constant (VERDICT r4 #2/#3/#4).

Usage (accelerator evidence run, the official one):
    python tools/accuracy_protocol.py --size 416 --seeds 3

CPU smoke (reduced):
    JAX_PLATFORMS=cpu python tools/accuracy_protocol.py \
        --size 128 --seeds 2 --steps 200 --tiers fp32,int16

Each tier's JSON records the protocol hash, so stale evidence (protocol
changed, resolution mismatch) is detectable by consumers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

T95 = {2: 12.706, 3: 4.303, 4: 3.182, 5: 2.776, 6: 2.571, 8: 2.365}


def ci95(vals: list[float]) -> float:
    n = len(vals)
    if n < 2:
        return float("nan")
    t = T95.get(n, 2.0)
    return float(t * np.std(vals, ddof=1) / np.sqrt(n))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, default=416,
                    help="train AND eval resolution (416 = the bench's)")
    ap.add_argument("--seeds", type=int, default=3)
    # 400 steps sufficed at 128² (4x4 region grid) but collapses
    # objectness at 416² (13x13 grid: ~10x fewer positives per cell) —
    # measured r5: seed-0 fp32 mAP 0.0 at 400 steps. Device-staged
    # batching keeps 2000 steps cheap.
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--compute", default="int32",
                    help="int16/int8 engine compute mode (bench default)")
    ap.add_argument("--tiers", default="fp32,int16,int8,w8a16")
    ap.add_argument("--thresh", type=float, default=0.05)
    ap.add_argument("--out-dir", default=os.path.join(REPO, "plans"))
    ap.add_argument("--scratch",
                    default=os.path.join(REPO, "results", "accuracy_v2"))
    args = ap.parse_args(argv)

    # region dumps off for the eval loop: two 71k-line text files per
    # image (~3 s each) quadrupled eval wall time in the first r5 run
    os.environ.setdefault("YOLO2_NO_DUMP", "1")

    import jax

    from yolotpu.compile_cache import configure as configure_compile_cache
    configure_compile_cache()

    from yolotpu import accuracy as acc
    from yolotpu import eval as yeval
    from yolotpu.models import zoo
    from yolotpu.quant import (calibrate_activations,
                               calibrate_activations_int8, quantize_weights,
                               quantize_weights_int8, quantize_weights_w8a16)
    from yolotpu.runtime.engine import Engine

    tiers = [t.strip() for t in args.tiers.split(",") if t.strip()]
    spec = zoo.build("yolov2", width=args.size, height=args.size)
    pairs = acc.write_eval_set(
        os.path.join(args.scratch, f"eval{args.size}"), args.size)
    calib = acc.calib_images(args.size)
    log = lambda m: print(f"# {m}", flush=True)  # noqa: E731
    log(f"protocol {acc.PROTOCOL['name']} hash={acc.protocol_hash()} "
        f"size={args.size} seeds={args.seeds} steps={args.steps} "
        f"backend={jax.default_backend()}")

    results: dict[str, list[float]] = {t: [] for t in tiers}
    for seed in range(args.seeds):
        t0 = time.time()
        cache = os.path.join(
            args.scratch,
            f"store_{acc.TRAIN_RECIPE}_s{seed}_{args.size}_{args.steps}.npz")
        from yolotpu.weights import WeightStore
        if os.path.exists(cache):
            z = np.load(cache)
            store = WeightStore(spec=spec)
            for l in spec.conv_layers():
                store.fp32[l.idx] = (z[f"w{l.idx}"], z[f"b{l.idx}"])
            log(f"seed {seed}: loaded cached weights {cache}")
        else:
            store, losses = acc.train_flagship_store(
                spec, seed=seed, size=args.size, steps=args.steps,
                batch=args.batch, log=log)
            np.savez(cache,
                     **{f"w{i}": w for i, (w, _) in store.fp32.items()},
                     **{f"b{i}": b for i, (_, b) in store.fp32.items()})
            log(f"seed {seed}: trained in {time.time() - t0:.0f}s "
                f"losses={losses}")

        # quantize exactly as the runtime defaults do
        act_q = calibrate_activations(spec, store, calib)
        quantize_weights(store, act_q)
        if "int8" in tiers:
            act_q8 = calibrate_activations_int8(spec, store, calib)
            quantize_weights_int8(store, act_q8)
        if "w8a16" in tiers:
            quantize_weights_w8a16(store, act_q)

        for tier in tiers:
            te = time.time()
            compute = args.compute if tier in ("int16", "int8") else "int32"
            eng = Engine(spec, store, precision=tier, backend="xla",
                         compute=compute)
            r = yeval.evaluate_engine(eng, pairs, num_classes=80,
                                      thresh=args.thresh)
            results[tier].append(r["mAP_50"])
            log(f"seed {seed} {tier}: mAP_50={r['mAP_50']:.4f} "
                f"({time.time() - te:.0f}s)")

    # ---- aggregate + emit evidence files -------------------------------
    os.makedirs(args.out_dir, exist_ok=True)
    fp32_vals = results.get("fp32", [])
    print("\n| tier | mAP_50 mean | CI95 | delta vs fp32 | delta CI95 |")
    print("|---|---|---|---|---|")
    for tier in tiers:
        vals = results[tier]
        mean = float(np.mean(vals))
        ci = ci95(vals)
        if fp32_vals and tier != "fp32":
            deltas = [v - f for v, f in zip(vals, fp32_vals)]
            dmean, dci = float(np.mean(deltas)), ci95(deltas)
        else:
            deltas, dmean, dci = [], 0.0, 0.0
        print(f"| {tier} | {mean:.4f} | ±{ci:.4f} | {dmean:+.4f} "
              f"| ±{dci:.4f} |")
        doc = {
            "tier": tier,
            "protocol": acc.PROTOCOL["name"],
            "protocol_hash": acc.protocol_hash(),
            "resolution": args.size,
            "train": {"size": args.size, "steps": args.steps,
                      "batch": args.batch, "seeds": args.seeds,
                      "recipe": acc.TRAIN_RECIPE},
            "eval_scenes": acc.PROTOCOL["eval_scenes"],
            "classes": acc.PROTOCOL["classes"],
            "engine": {"backend": "xla",
                       "compute": (args.compute
                                   if tier in ("int16", "int8")
                                   else "int32"),
                       "thresh": args.thresh},
            "backend_platform": jax.default_backend(),
            "mAP_50_per_seed": [round(v, 4) for v in vals],
            "mAP_50_mean": round(mean, 4),
            "mAP_50_ci95": round(ci, 4) if np.isfinite(ci) else None,
            "fp32_mAP_50_per_seed": [round(v, 4) for v in fp32_vals],
            "delta_vs_fp32_mean": round(dmean, 4),
            "delta_vs_fp32_ci95": (round(dci, 4)
                                   if deltas and np.isfinite(dci) else None),
            "date": time.strftime("%Y-%m-%d"),
        }
        path = os.path.join(args.out_dir, f"accuracy_{tier}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
        log(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
