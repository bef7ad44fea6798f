"""``yolov2_detect``-compatible detection CLI on the accelerator.

Flag contract follows the reference host CLI
(``src/models/yolov2/yolov2_main.cpp:62-131``): --cfg --names --input
--output --thresh --nms --hier --backend --precision, positional input image,
default output prefix ``results/<stem>_prediction``; region dumps controlled
by YOLO2_DUMP_REGION[_RAW] / YOLO2_NO_DUMP.

Backends map to this framework's executors: the reference's "hls" (the
accelerator simulation) becomes "xla" (the jitted XLA program); "cpu"/"golden" is
the numpy oracle — actually implemented here, unlike the reference's stub
(``yolov2_main.cpp:287-292``). Extra flags cover what the reference bakes in:
--model (built-in zoo instead of a cfg file), --weights-dir (artifact
directory), --synthetic-weights, --compute, --seed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="yolov2_detect", description=__doc__)
    ap.add_argument("--cfg", default=None, help="darknet cfg path")
    ap.add_argument("--model", default="yolov2",
                    help="built-in model name (used when --cfg not given)")
    ap.add_argument("--names", default=None, help="class names file")
    ap.add_argument("--input", default=None, help="input image")
    ap.add_argument("--output", default=None,
                    help="output file prefix without extension")
    ap.add_argument("--thresh", type=float, default=0.25)
    ap.add_argument("--nms", type=float, default=0.45)
    ap.add_argument("--hier", type=float, default=0.5)
    ap.add_argument("--topk", type=int, default=256,
                    help="device-NMS candidate cap (with --device-nms)")
    ap.add_argument("--dump-layers", default=None, metavar="DIR",
                    help="write every layer's output as DIR/layerNN.bin "
                         "(raw CHW; env YOLO2_DUMP_LAYERS also works) — "
                         "the cosim per-layer dump analog")
    ap.add_argument("--backend", default="xla",
                    choices=["xla", "hls", "cpu", "golden"],
                    help="'hls' aliases to xla; 'cpu' to golden")
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "int16", "int8", "w8a16"])
    ap.add_argument("--compute", default="int32",
                    choices=["int32", "f32", "f32_highest", "exact"],
                    help="int16 conv compute mode (int32 = exact integer "
                         "accumulation; exact = the golden engine replica)")
    ap.add_argument("--weights-dir", default="weights",
                    help="directory with the .bin artifact set")
    ap.add_argument("--synthetic-weights", action="store_true",
                    help="generate seeded synthetic weights")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--net-size", type=int, default=None, metavar="N",
                    help="override the network input size (zoo models only;"
                         " small smoke runs)")
    ap.add_argument("-v", "--verbose", type=int, default=None)
    ap.add_argument("positional", nargs="?", default=None,
                    help="input image (positional)")
    return ap


def default_names(classes: int) -> list[str] | None:
    """Built-in class-name table for the class count (COCO-80 / VOC-20)."""
    from ..names import names_for
    return names_for(classes)


def main(argv: list[str] | None = None) -> int:
    from ..compile_cache import configure as configure_compile_cache
    from ..graph import NetworkSpec
    from ..image import load_image, save_image
    from ..models import zoo
    from ..runtime import logging as ylog
    from ..runtime.drawing import draw_detections
    from ..runtime.engine import Engine, load_or_synthesize

    args = build_argparser().parse_args(argv)
    configure_compile_cache()
    if args.verbose is not None:
        ylog.set_level(args.verbose)
    input_path = args.input or args.positional
    if input_path is None:
        print("error: no input image (use --input or positional)", file=sys.stderr)
        return 2

    # quiet=False: unused-key warnings, like the reference parser
    spec = (NetworkSpec.from_cfg(args.cfg, quiet=False) if args.cfg
            else zoo.build(args.model, width=args.net_size,
                           height=args.net_size))
    spec.describe()

    backend = {"hls": "xla", "cpu": "golden"}.get(args.backend, args.backend)
    compute = args.compute
    if compute == "exact" and backend != "golden":
        print("note: compute=exact implies the golden backend", file=sys.stderr)
        backend = "golden"

    im = load_image(input_path)
    store = load_or_synthesize(spec, args.weights_dir, args.precision,
                               synthetic=args.synthetic_weights,
                               seed=args.seed)
    t0 = time.time()
    eng = Engine(spec, store, precision=args.precision, backend=backend,
                 compute=compute, topk=args.topk)
    ylog.info(f"engine ready in {time.time() - t0:.1f}s "
              f"({backend}/{args.precision})")

    dets, res = eng.detect(im, thresh=args.thresh, nms=args.nms)
    print(f"{os.path.basename(input_path)}: predicted in {res.seconds:.6f} seconds.")

    dump_dir = args.dump_layers or os.environ.get("YOLO2_DUMP_LAYERS")
    if dump_dir:
        from ..image import letterbox_image
        boxed = letterbox_image(im, spec.net.width, spec.net.height)
        eng.dump_layers(boxed, dump_dir)

    if args.names:
        names = [l.rstrip("\n") for l in open(args.names)]
    else:
        names = (default_names(spec.region.classes)
                 or [str(i) for i in range(spec.region.classes)])
    shown = 0
    for d in dets:
        for j in range(d.classes):
            if d.prob[j] > args.thresh:
                print(f"{names[j] if j < len(names) else j}: {100 * d.prob[j]:.0f}%")
                shown += 1

    prefix = args.output
    if prefix is None:
        stem = os.path.splitext(os.path.basename(input_path))[0]
        os.makedirs("results", exist_ok=True)
        prefix = os.path.join("results", f"{stem}_prediction")
    drawn = draw_detections(im, dets, names, args.thresh)
    save_image(drawn, prefix + ".png")
    ylog.info(f"saved {prefix}.png ({shown} labels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
