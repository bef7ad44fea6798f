"""Staged pipeline runner: ``run_pipeline.py`` equivalent.

The reference drives host-sanity -> quickstart -> HLS IP -> Vivado ->
firmware packaging -> deploy -> board run (``scripts/run_pipeline.py:847-
855``), YAML-configured with --from/--to stage windowing (``:866-888``).
This flow has no bitstream; its stages are:

  host_sanity     tool/import checks (python, jax, packages, toolchain)
  artifacts       synthetic or real weight artifacts + int16 quantization
  host_quickstart golden fp32 + int16 smoke detection (the reference's
                  host quickstart gate, run_pipeline.py:394-449)
  compile         jit + compile-check of the flagship program
  run             timed detection run on the device
  report          report bundle via yolo2_report

Stage windowing (--from/--to), per-stage ordering and a YAML config are
preserved. Re-entry is cheap because artifacts are cached on disk.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

STAGES = ["host_sanity", "artifacts", "host_quickstart",
          "compile", "run", "report"]

DEFAULT_CONFIG = """\
# yolotpu pipeline configuration (run_pipeline equivalent)
model: yolov2
precision: int16
compute: int32
weights_dir: weights
synthetic_weights: true
test_image: null          # defaults to a generated image
report_label: pipeline
batch: 16
steps: 10
"""


def _load_config(path: str | None) -> dict:
    import yaml
    cfg = yaml.safe_load(DEFAULT_CONFIG)
    if path:
        with open(path) as f:
            cfg.update(yaml.safe_load(f) or {})
    return cfg


def stage_host_sanity(cfg: dict) -> None:
    import importlib
    import shutil
    for mod in ("numpy", "jax", "PIL", "yaml"):
        importlib.import_module(mod)
    print(f"  python {sys.version.split()[0]}")
    import jax
    print(f"  jax {jax.__version__}, backend={jax.default_backend()}, "
          f"devices={len(jax.devices())}")
    for tool in ("g++",):
        print(f"  {tool}: {'ok' if shutil.which(tool) else 'MISSING (native preproc disabled)'}")


def _test_image(cfg: dict):
    import numpy as np
    from ..image import load_image
    if cfg.get("test_image"):
        return load_image(cfg["test_image"])
    rng = np.random.default_rng(7)
    return rng.random((3, 416, 416)).astype(np.float32)


def stage_artifacts(cfg: dict) -> None:
    from ..models import zoo
    from ..quant import calibrate_activations, quantize_weights
    from ..weights import WeightStore
    wd = cfg["weights_dir"]
    spec = zoo.build(cfg["model"])
    if cfg.get("synthetic_weights", True):
        store = WeightStore.synthetic(spec, seed=0)
        store.save_fp32(wd)
        act_q = calibrate_activations(spec, store, [_test_image(cfg)])
        quantize_weights(store, act_q)
        store.save_int16(wd)
        print(f"  synthetic artifact set -> {wd}/")
    else:
        if not os.path.exists(os.path.join(wd, "weights.bin")):
            raise FileNotFoundError(f"real weights not found in {wd}/")
        print(f"  using existing artifacts in {wd}/")


def stage_host_quickstart(cfg: dict) -> None:
    from ..models import zoo
    from ..runtime.engine import Engine, load_or_synthesize
    spec = zoo.build(cfg["model"], width=128, height=128)
    img = _test_image(cfg)[:, :128, :128]
    for precision in ("fp32", "int16"):
        store = load_or_synthesize(spec, None, precision, synthetic=True)
        compute = "exact" if precision == "int16" else "int32"
        eng = Engine(spec, store, precision=precision, backend="golden",
                     compute=compute)
        dets, res = eng.detect(img, 0.25, 0.45)
        print(f"  golden {precision}: {len(dets)} dets in {res.seconds:.2f}s")


def stage_compile(cfg: dict) -> None:
    import jax
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    import __graft_entry__ as ge
    fn, args = ge.entry()
    t0 = time.time()
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    print(f"  compiled in {time.time() - t0:.1f}s on {jax.devices()[0].device_kind}")


def stage_run(cfg: dict) -> None:
    from . import report as rp
    args = ["--report-dir", "reports", "run", "--label", "pipeline_run",
            "--model", cfg["model"], "--precision", cfg["precision"],
            "--compute", cfg["compute"], "--batch", str(cfg["batch"]),
            "--steps", str(cfg["steps"])]
    if cfg.get("synthetic_weights", True):
        args.append("--synthetic-weights")
    rp.main(args)


def stage_report(cfg: dict) -> None:
    from . import report as rp
    rp.main(["--report-dir", "reports", "list"])


STAGE_FNS = {
    "host_sanity": stage_host_sanity,
    "artifacts": stage_artifacts,
    "host_quickstart": stage_host_quickstart,
    "compile": stage_compile,
    "run": stage_run,
    "report": stage_report,
}


def compute_stage_list(from_stage: str | None, to_stage: str | None) -> list[str]:
    """--from/--to windowing (run_pipeline.py:866-888)."""
    lo = STAGES.index(from_stage) if from_stage else 0
    hi = STAGES.index(to_stage) if to_stage else len(STAGES) - 1
    if lo > hi:
        raise ValueError(f"--from {from_stage} is after --to {to_stage}")
    return STAGES[lo:hi + 1]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="run_pipeline", description=__doc__)
    ap.add_argument("--config", default=None, help="pipeline YAML")
    ap.add_argument("--from", dest="from_stage", choices=STAGES, default=None)
    ap.add_argument("--to", dest="to_stage", choices=STAGES, default=None)
    ap.add_argument("--list-stages", action="store_true")
    ap.add_argument("--init-config", metavar="PATH",
                    help="write a config template and exit")
    args = ap.parse_args(argv)

    if args.list_stages:
        print("\n".join(STAGES))
        return 0
    if args.init_config:
        with open(args.init_config, "w") as f:
            f.write(DEFAULT_CONFIG)
        print(f"wrote {args.init_config}")
        return 0

    cfg = _load_config(args.config)
    stages = compute_stage_list(args.from_stage, args.to_stage)
    for i, st in enumerate(stages, 1):
        print(f"[{i}/{len(stages)}] stage {st}")
        t0 = time.time()
        try:
            STAGE_FNS[st](cfg)
        except Exception as e:
            print(f"  FAILED after {time.time() - t0:.1f}s: {e}", file=sys.stderr)
            return 1
        print(f"  ok ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
