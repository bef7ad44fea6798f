"""Training CLI: regenerate weight artifacts natively on the accelerator.

The reference outsources weight production to an external repo
(``weights/README.md:33-59``); this trainer closes the loop: darknet-format
datasets (image + ``class cx cy w h`` label files) -> region-loss SGD ->
checkpoints -> the standard weight artifact contract (+ optional int16
quantization), all on the same mesh shardings as inference.

Dataset format: a list file of image paths; each image's label file sits
next to it with .txt extension (darknet convention).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def load_batch(paths, labels, spec, rng, batch, max_boxes=30):
    from ..image import letterbox_image, load_image
    from ..eval import load_darknet_labels
    idx = rng.integers(0, len(paths), batch)
    imgs, boxes, classes, mask = [], [], [], []
    for i in idx:
        im = load_image(paths[i])
        imgs.append(letterbox_image(im, spec.net.width, spec.net.height)
                    .transpose(1, 2, 0))
        gt = load_darknet_labels(labels[i])
        n = min(gt.boxes.shape[0], max_boxes)
        b = np.zeros((max_boxes, 4), np.float32)
        c = np.zeros((max_boxes,), np.int32)
        m = np.zeros((max_boxes,), np.float32)
        b[:n], c[:n], m[:n] = gt.boxes[:n], gt.classes[:n], 1.0
        boxes.append(b); classes.append(c); mask.append(m)
    return {"images": np.stack(imgs), "boxes": np.stack(boxes),
            "classes": np.stack(classes), "mask": np.stack(mask)}


def synthetic_batch(spec, rng, batch, max_boxes=30):
    b = np.zeros((batch, max_boxes, 4), np.float32)
    c = np.zeros((batch, max_boxes), np.int32)
    m = np.zeros((batch, max_boxes), np.float32)
    n = 4
    b[:, :n] = rng.uniform(0.2, 0.8, (batch, n, 4)).astype(np.float32)
    b[:, :n, 2:] = rng.uniform(0.05, 0.3, (batch, n, 2)).astype(np.float32)
    c[:, :n] = rng.integers(0, spec.region.classes, (batch, n))
    m[:, :n] = 1.0
    return {"images": rng.random((batch, spec.net.height, spec.net.width, 3),
                                 dtype=np.float32),
            "boxes": b, "classes": c, "mask": m}


def main(argv: list[str] | None = None) -> int:
    import jax
    import jax.numpy as jnp

    from ..checkpoint import (export_weight_artifacts, latest_checkpoint,
                              load_checkpoint, save_checkpoint)
    from ..models import yolov2 as m
    from ..models import zoo
    from ..train import make_train_step, zeros_like_velocity
    from ..weights import WeightStore

    ap = argparse.ArgumentParser(prog="yolo2_train", description=__doc__)
    ap.add_argument("--model", default="yolov2")
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--train-list", default=None,
                    help="file listing training image paths (darknet style)")
    ap.add_argument("--synthetic-data", action="store_true")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--export-weights", default=None,
                    help="directory for weights.bin/bias.bin at the end")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", action="store_true",
                    help="shard over all visible devices (dp x tp)")
    args = ap.parse_args(argv)
    from ..compile_cache import configure as configure_compile_cache
    configure_compile_cache()

    from ..graph import NetworkSpec
    spec = (NetworkSpec.from_cfg(args.cfg) if args.cfg
            else zoo.build(args.model, width=args.width, height=args.height))
    rng = np.random.default_rng(args.seed)

    store = WeightStore.synthetic(spec, seed=args.seed)
    params = m.params_fp32(spec, store)
    velocity = zeros_like_velocity(params)
    start_step = 0
    if args.resume:
        ck = latest_checkpoint(args.ckpt_dir)
        if ck:
            start_step, ptree, vtree = load_checkpoint(ck)
            params = jax.tree_util.tree_map(jnp.asarray, ptree)
            velocity = (jax.tree_util.tree_map(jnp.asarray, vtree)
                        if vtree else zeros_like_velocity(params))
            print(f"resumed from {ck} at step {start_step}")

    if args.mesh and len(jax.devices()) > 1:
        from ..parallel import mesh as pmesh
        mesh = pmesh.make_mesh()
        sh = pmesh.param_shardings(params, mesh)
        put = lambda t: jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, s), t, sh,
            is_leaf=lambda x: not isinstance(x, dict))
        params, velocity = put(params), put(velocity)
        print(f"mesh: {dict(mesh.shape)}")

    paths = labels = None
    if args.train_list:
        paths = [l.strip() for l in open(args.train_list) if l.strip()]
        labels = [os.path.splitext(p)[0] + ".txt" for p in paths]
    elif not args.synthetic_data:
        print("note: no --train-list; using --synthetic-data")

    step_fn = jax.jit(make_train_step(spec, lr=args.lr,
                                      momentum=args.momentum))
    t0 = time.time()
    for step in range(start_step, args.steps):
        if paths:
            batch = load_batch(paths, labels, spec, rng, args.batch)
        else:
            batch = synthetic_batch(spec, rng, args.batch)
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        params, velocity, loss = step_fn(params, velocity, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step}: loss {float(loss):.4f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            p = save_checkpoint(args.ckpt_dir, step + 1,
                                jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, velocity))
            print(f"checkpoint: {p}")

    save_checkpoint(args.ckpt_dir, args.steps,
                    jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, velocity))
    if args.export_weights:
        export_weight_artifacts(
            jax.tree_util.tree_map(np.asarray, params), spec,
            args.export_weights)
        print(f"exported weight artifacts to {args.export_weights}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
