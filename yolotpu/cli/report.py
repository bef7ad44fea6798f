"""Performance report bundles: ``yolo2_report.py`` equivalent.

The reference tool bundles HLS csynth XML, Vivado timing/utilization/power
reports and board logs into ``reports/<ts>_<label>/{meta,metrics}.json +
summary.md`` with a ``compare`` diff view (``scripts/yolo2_report.py``,
``scripts/YOLO2_REPORT_TOOL.md:163-199``). The analog here collects:

- run metrics: mean/median/p90 step latency and FPS from timed inferences
  (the same statistics the reference regexes out of board logs),
- "utilization": XLA compile time and the compiled program's memory
  analysis (device argument/output/temp sizes — the LUT/DSP table's
  analog),
- environment: device kind, jax version, precision/compute mode.

Subcommands: init, run, list, compare.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from datetime import datetime

REPORT_DIR = "reports"
PLANS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "plans")


def _metrics_run(args) -> dict:
    import numpy as np
    import jax
    import jax.numpy as jnp

    from ..models import yolov2 as m
    from ..models import zoo
    from ..runtime.engine import load_or_synthesize
    from ..runtime.profiler import StepTimer

    spec = zoo.build(args.model, width=args.width, height=args.height)
    store = load_or_synthesize(spec, args.weights_dir, args.precision,
                               synthetic=args.synthetic_weights)
    if args.precision == "int16":
        params = m.params_int16(spec, store)
        fwd = m.build_forward(spec, "int16", store.qtables, args.compute,
                              ("head", "boxes"))
    elif args.precision == "int8":
        params = m.params_int8(spec, store)
        fwd = m.build_forward(spec, "int8", store.qtables8, args.compute,
                              ("head", "boxes"))
    elif args.precision == "w8a16":
        params = m.params_w8a16(spec, store)
        fwd = m.build_forward(spec, "w8a16", store.qtables_w8, args.compute,
                              ("head", "boxes"))
    else:
        params = m.params_fp32(spec, store)
        fwd = m.build_forward(spec, "fp32", outputs=("head", "boxes"))
    fn = jax.jit(lambda x: fwd(params, x))

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random(
        (args.batch, spec.net.height, spec.net.width, 3), dtype=np.float32))

    t0 = time.perf_counter()
    lowered = fn.lower(x)
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0
    mem = {}
    try:
        ma = compiled.memory_analysis()
        for k in ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes"):
            v = getattr(ma, k, None)
            if v is not None:
                mem[k] = int(v)
    except Exception:
        pass

    jax.block_until_ready(compiled(x))
    timer = StepTimer()
    for _i in range(args.steps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(x))
        timer.add((time.perf_counter() - t0) * 1e3)
    summary = timer.summary(frames_per_step=args.batch)

    b1 = {}
    if args.batch1_p50:
        # Single-frame latency: chain-dispatch N batch-1 steps on distinct
        # inputs, wait for the last, divide (the board logs wall time per
        # inference, yolo2_inference.c:75-142)
        x1 = x[:1]
        n = max(8, int(args.batch1_chain))
        xs = [x1 + jnp.float32(i) * jnp.float32(1e-6) for i in range(n)]
        jax.block_until_ready([fn(v) for v in xs])
        reps = []
        for _i in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready([fn(v)["obj"] for v in xs])
            reps.append(time.perf_counter() - t0)
        b1 = {"batch1_p50_ms": round(float(np.median(reps)) * 1e3 / n, 3),
              "batch1_chain": n}

    per_layer = None
    if args.profile_layers:
        # Per-layer achieved TOPS / GB/s via in-program prefix bisection —
        # the utilization analog of the csynth DSP/LUT/BRAM table the
        # reference report parses (scripts/yolo2_report.py:131+).
        from ..runtime.profiler import profile_prefix
        rep = profile_prefix(spec, store, precision=args.precision,
                             compute=args.compute, batch=args.batch)
        per_layer = rep.as_dicts()

    # Accuracy evidence for this tier at this resolution (written by
    # tools/accuracy_protocol.py): the bundle then carries fps + p50 +
    # mAP delta for one configuration in one artifact (VERDICT r4 #4).
    accuracy = None
    try:
        from ..accuracy import protocol_hash
        ap = os.path.join(PLANS_DIR, f"accuracy_{args.precision}.json")
        if os.path.exists(ap):
            doc = json.load(open(ap))
            if (doc.get("protocol_hash") == protocol_hash()
                    and doc.get("resolution") == spec.net.width):
                accuracy = doc
    except Exception:
        pass

    dev = jax.devices()[0]
    return {
        **b1,
        **({"per_layer": per_layer} if per_layer else {}),
        **({"accuracy": accuracy} if accuracy else {}),
        "model": args.model,
        "precision": args.precision,
        "compute": args.compute,
        "batch": args.batch,
        "steps": args.steps,
        "device": str(dev.device_kind),
        "platform": jax.default_backend(),
        "jax_version": jax.__version__,
        "compile_seconds": round(compile_s, 2),
        "memory_analysis": mem,
        "latency": summary,
    }


def _render_summary(meta: dict, metrics: dict) -> str:
    lat = metrics.get("latency", {})
    lines = [
        f"# Report: {meta['label']}",
        "",
        f"- timestamp: {meta['timestamp']}",
        f"- model: {metrics['model']}  precision: {metrics['precision']}"
        f" ({metrics['compute']})  batch: {metrics['batch']}",
        f"- device: {metrics['device']} ({metrics['platform']}),"
        f" jax {metrics['jax_version']}",
        f"- compile: {metrics['compile_seconds']} s",
        "",
        "## Latency / throughput",
        f"- steps: {lat.get('count', 0)}",
        f"- mean: {lat.get('mean_ms', 0):.2f} ms   median: "
        f"{lat.get('median_ms', 0):.2f} ms   p90: {lat.get('p90_ms', 0):.2f} ms",
        f"- throughput: {lat.get('fps', 0):.1f} frames/sec",
    ]
    if metrics.get("batch1_p50_ms") is not None:
        lines.append(
            f"- single-frame p50: {metrics['batch1_p50_ms']}"
            f" ms (chain of {metrics.get('batch1_chain')})")
    acc = metrics.get("accuracy")
    if acc:
        lines += [
            "",
            "## Accuracy (protocol evidence, same tier/resolution)",
            f"- mAP_50: {acc['mAP_50_mean']} ±{acc.get('mAP_50_ci95')}"
            f" ({acc['train']['seeds']} seeds, {acc['eval_scenes']} scenes,"
            f" {acc['classes']} classes)",
            f"- delta vs fp32: {acc['delta_vs_fp32_mean']:+}"
            f" ±{acc.get('delta_vs_fp32_ci95')}"
            f" (protocol {acc['protocol']} {acc['protocol_hash']})",
        ]
    lines += [
        "",
        "## Memory (XLA)",
    ]
    for k, v in metrics.get("memory_analysis", {}).items():
        lines.append(f"- {k}: {v / 1e6:.1f} MB")
    if metrics.get("per_layer"):
        lines += ["", "## Per-layer utilization (in-program prefix deltas)",
                  "", "| layer | type | ms | TOPS | GB/s | detail |",
                  "|---|---|---|---|---|---|"]
        for t in metrics["per_layer"]:
            lines.append(f"| {t['idx']} | {t['type']} | {t['ms']:.3f} | "
                         f"{t['tops']:.1f} | {t['gbs']:.0f} | "
                         f"{t['detail']} |")
    return "\n".join(lines) + "\n"


def cmd_run(args) -> int:
    from ..compile_cache import configure as configure_compile_cache
    configure_compile_cache()
    metrics = _metrics_run(args)
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    d = os.path.join(args.report_dir, f"{ts}_{args.label}")
    os.makedirs(d, exist_ok=True)
    meta = {"label": args.label, "timestamp": ts,
            "argv": sys.argv[1:]}
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(d, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    with open(os.path.join(d, "summary.md"), "w") as f:
        f.write(_render_summary(meta, metrics))
    print(d)
    return 0


def cmd_list(args) -> int:
    if not os.path.isdir(args.report_dir):
        return 0
    for name in sorted(os.listdir(args.report_dir)):
        mp = os.path.join(args.report_dir, name, "metrics.json")
        if os.path.exists(mp):
            mtr = json.load(open(mp))
            lat = mtr.get("latency", {})
            print(f"{name}: {mtr.get('model')} {mtr.get('precision')}"
                  f" b{mtr.get('batch')} -> {lat.get('fps', 0):.1f} fps"
                  f" (p50 {lat.get('median_ms', 0):.2f} ms)")
    return 0


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        elif isinstance(v, (int, float)):
            out[key] = v
    return out


def cmd_compare(args) -> int:
    ja = json.load(open(os.path.join(args.report_dir, args.a, "metrics.json")))
    jb = json.load(open(os.path.join(args.report_dir, args.b, "metrics.json")))
    a, b = _flatten(ja), _flatten(jb)
    keys = sorted(set(a) | set(b))
    print(f"{'metric':42s} {args.a[:18]:>18s} {args.b[:18]:>18s}   delta")
    for k in keys:
        va, vb = a.get(k), b.get(k)
        if va is None or vb is None:
            continue
        delta = ""
        if isinstance(va, (int, float)) and va:
            delta = f"{100.0 * (vb - va) / abs(va):+.1f}%"
        print(f"{k:42s} {va:>18} {vb:>18}   {delta}")
    # per-layer utilization deltas when both bundles carry the table
    pa = {t["idx"]: t for t in ja.get("per_layer") or []}
    pb = {t["idx"]: t for t in jb.get("per_layer") or []}
    common = sorted(set(pa) & set(pb))
    if common:
        print(f"\n{'layer':>5s} {'type':14s} {'ms A':>8s} {'ms B':>8s}"
              f"   delta   detail")
        for i in common:
            ta, tb = pa[i], pb[i]
            d = (f"{100.0 * (tb['ms'] - ta['ms']) / ta['ms']:+.1f}%"
                 if ta["ms"] else "")
            print(f"{i:5d} {ta['type']:14s} {ta['ms']:8.3f} "
                  f"{tb['ms']:8.3f}   {d:>7s} {tb.get('detail', '')}")
    return 0


def cmd_init(args) -> int:
    os.makedirs(args.report_dir, exist_ok=True)
    print(f"initialized {args.report_dir}/")
    return 0


def parse_inference_log(path: str) -> dict:
    """Extract 'inference time: X ms' lines from a run log and compute
    count/mean/median/p90/FPS — exactly the reference report tool's KV260
    log ingestion (scripts/YOLO2_REPORT_TOOL.md:177-184). The streaming
    runtime emits the same lines at verbosity >= 2."""
    import re
    import numpy as np
    pat = re.compile(r"inference time:\s*([0-9.]+)\s*ms")
    vals = []
    with open(path) as f:
        for line in f:
            m = pat.search(line)
            if m:
                vals.append(float(m.group(1)))
    if not vals:
        return {"count": 0}
    a = np.asarray(vals)
    return {
        "count": int(a.size),
        "mean_ms": round(float(a.mean()), 3),
        "median_ms": round(float(np.median(a)), 3),
        "p90_ms": round(float(np.percentile(a, 90)), 3),
        "fps": round(float(1000.0 / np.median(a)), 2),
    }


def cmd_parse_log(args) -> int:
    stats = parse_inference_log(args.log)
    print(json.dumps(stats, indent=2))
    return 0 if stats.get("count") else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="yolo2_report", description=__doc__)
    ap.add_argument("--report-dir", default=REPORT_DIR)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("init")
    runp = sub.add_parser("run")
    runp.add_argument("--label", default="run")
    runp.add_argument("--model", default="yolov2")
    runp.add_argument("--precision", default="int16",
                      choices=["fp32", "int16", "int8", "w8a16"])
    runp.add_argument("--compute", default="int32")
    runp.add_argument("--batch", type=int, default=16)
    runp.add_argument("--steps", type=int, default=10)
    runp.add_argument("--width", type=int, default=None)
    runp.add_argument("--height", type=int, default=None)
    runp.add_argument("--weights-dir", default="weights")
    runp.add_argument("--synthetic-weights", action="store_true")
    runp.add_argument("--batch1-p50", action="store_true", default=True,
                      help="measure single-frame latency via a "
                           "chain-dispatch (default on)")
    runp.add_argument("--no-batch1-p50", dest="batch1_p50",
                      action="store_false")
    runp.add_argument("--batch1-chain", type=int, default=32)
    runp.add_argument("--profile-layers", action="store_true",
                      help="add per-layer achieved TOPS / GB/s to the "
                           "bundle (compiles one prefix program per layer; "
                           "minutes with a warm cache)")
    sub.add_parser("list")
    cmp_ = sub.add_parser("compare")
    cmp_.add_argument("a")
    cmp_.add_argument("b")
    plog = sub.add_parser("parse-log")
    plog.add_argument("log")
    args = ap.parse_args(argv)
    return {"init": cmd_init, "run": cmd_run, "list": cmd_list,
            "compare": cmd_compare, "parse-log": cmd_parse_log}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
