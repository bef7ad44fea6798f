"""Inference engine: weights + graph + backend -> detections.

Plays the role of the reference's host shim ``yolov2_hls_ps``
(``hls/models/yolov2/yolo2_model.cpp:229-449``) and the board orchestrator
``yolo2_run_inference`` (``linux_app/src/yolo2_inference.c:763-910``), except
the 32 per-layer launches collapse into one jitted XLA program and the DDR
ping-pong arena disappears into XLA buffer assignment.

Backends:
  "xla"    — the device path (fp32 / int16 / int8 / w8a16; int16 compute
             mode selectable; optional on-device NMS and letterbox)
  "golden" — the numpy oracle (the "host simulation" analog; also the
             bit-exact reference-semantics mode via compute="exact")
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import numpy as np

from ..golden import GoldenNet
from ..graph import NetworkSpec
from ..postprocess import (Detection, do_nms_sort, forward_region,
                           get_region_detections)
from ..quant import calibrate_activations, quantize_weights
from ..weights import WeightStore
from . import logging as ylog


@dataclass
class PredictResult:
    head_chw: np.ndarray          # (oc, h, w) fp32 raw region input
    seconds: float


class Engine:
    def __init__(self, spec: NetworkSpec, store: WeightStore,
                 precision: str = "fp32", backend: str = "xla",
                 compute: str = "int32", device_nms: bool = False,
                 thresh: float = 0.25, nms: float = 0.45, topk: int = 256,
                 warmup: bool = True, warmup_batch: int = 1):
        self.spec = spec
        self.store = store
        self.precision = precision
        self.backend = backend
        self.compute = compute
        self.device_nms = device_nms and backend == "xla"
        self._fn = None
        if precision == "int16" and not store.int16:
            raise ValueError("int16 engine needs quantized weights "
                             "(load int16 artifacts or calibrate+quantize)")
        if precision == "int8" and not store.int8:
            raise ValueError("int8 engine needs quantize_weights_int8")
        if precision == "w8a16" and not store.w8a16:
            raise ValueError("w8a16 engine needs quantize_weights_w8a16")
        if backend == "xla":
            from ..models import yolov2 as m
            t0 = time.time()
            outputs = (("head", "detections") if self.device_nms
                       else ("head",))
            import jax
            if precision == "int16":
                params = m.params_int16(spec, store)
                fwd = m.build_forward(spec, "int16", store.qtables, compute,
                                      outputs, thresh=thresh,
                                      nms_thresh=nms, topk=topk)
            elif precision == "int8":
                params = m.params_int8(spec, store)
                fwd = m.build_forward(spec, "int8", store.qtables8, compute,
                                      outputs, thresh=thresh,
                                      nms_thresh=nms, topk=topk)
            elif precision == "w8a16":
                params = m.params_w8a16(spec, store)
                fwd = m.build_forward(spec, "w8a16", store.qtables_w8,
                                      compute, outputs, thresh=thresh,
                                      nms_thresh=nms, topk=topk)
            else:
                params = m.params_fp32(spec, store)
                fwd = m.build_forward(spec, "fp32", outputs=outputs,
                                      thresh=thresh, nms_thresh=nms,
                                      topk=topk)
            # params are jit ARGUMENTS, not closed-over constants: the
            # program (and its compile-cache entry) stays weight-free
            self._fwd, self._params = fwd, params
            self._jit = jax.jit(fwd)
            self._fn = lambda x: self._jit(self._params, x)
            self._lbox_fns: dict = {}
            if warmup:
                # compile now (at the batch the runtime will use) so the
                # first predict() reports inference time, not compile time,
                # and the streaming watchdog never times a compile (the
                # board app similarly frontloads setup, main.c:559-735)
                import jax.numpy as jnp
                z = jnp.zeros((warmup_batch, spec.net.height, spec.net.width,
                               spec.net.channels), jnp.float32)
                jax.block_until_ready(self._fn(z))
            ylog.debug(f"engine: forward built in {time.time() - t0:.1f}s")
        elif backend == "golden":
            self._golden = GoldenNet(spec)
        else:
            raise ValueError(f"backend {backend!r} (use 'xla' or 'golden')")

    # Max abandoned (timed-out, still-parked) watchdog threads before the
    # engine fails fast instead of dispatching again: a wedged device must
    # not stack daemon threads silently.
    WATCHDOG_MAX_ABANDONED = int(os.environ.get(
        "YOLO2_WATCHDOG_MAX_ABANDONED", "4"))

    def compile(self, x):
        """The compiled main program for input ``x`` (e.g. to read its
        ``memory_analysis()``); xla backend only."""
        return self._jit.lower(self._params, x).compile()

    # ------------------------------------------------------------------
    def _guarded(self, fn, *args, tag: str = "main"):
        """Per-inference watchdog, the board app's wait_for_idle analog
        (yolo2_accel_linux.c:266-381, default yolo2_config.h:141): every
        device invocation — not just the streaming loop — is bounded by
        YOLO2_LAYER_TIMEOUT_MS. A shape seen for the first time gets a
        raised deadline (>=900 s) because it may trigger a compile, like
        the streaming runner's first-batch allowance."""
        try:
            ms = float(os.environ.get("YOLO2_LAYER_TIMEOUT_MS", "60000"))
        except ValueError:
            ms = 60000.0
        if ms <= 0:
            return fn(*args)
        key = (tag,) + tuple(getattr(a, "shape", None) for a in args)
        if not hasattr(self, "_seen_shapes"):
            self._seen_shapes = set()
        if key not in self._seen_shapes:
            ms = max(ms, 900_000.0)
        if not hasattr(self, "_abandoned_threads"):
            self._abandoned_threads: list = []
        # prune workers that eventually completed; fail fast when the cap
        # of still-parked ones is reached (each is a device call that never
        # returned — more dispatches into a wedged device only stack more)
        self._abandoned_threads = [t for t in self._abandoned_threads
                                   if t.is_alive()]
        if len(self._abandoned_threads) >= self.WATCHDOG_MAX_ABANDONED:
            raise RuntimeError(
                f"watchdog: {len(self._abandoned_threads)} abandoned device "
                "calls still parked (cap "
                f"{self.WATCHDOG_MAX_ABANDONED}); refusing to dispatch — "
                "the device looks wedged, restart the engine")

        def dispatch():
            """Run fn on a DAEMON thread so a genuinely hung device call
            never blocks interpreter exit (a ThreadPoolExecutor worker is
            non-daemon and is joined by the atexit hook). Returns
            (ok, value_or_exc)."""
            box: list = []

            def work():
                try:
                    box.append((True, fn(*args)))
                except BaseException as e:  # surfaced to the caller below
                    box.append((False, e))

            t = threading.Thread(target=work, daemon=True,
                                 name=f"yolo2-watchdog-{tag}")
            t.start()
            t.join(timeout=ms / 1000.0)
            if t.is_alive():
                # timed out; track the abandoned worker for the fail-fast cap
                self._abandoned_threads.append(t)
                return None
            ok, val = box[0]
            if not ok:
                raise val
            return (val,)

        out = dispatch()
        if out is None:
            # Recovery attempt before giving up, mirroring the reference
            # driver's timeout path (clear START, decode status, resume —
            # yolo2_accel_linux.c:350-377): re-dispatch the step ONCE on a
            # fresh daemon thread with a fresh deadline. A transient
            # device-queue stall clears; a truly hung program times out
            # again and raises. The stuck worker is a daemon thread — it
            # cannot block exit; its result (if it ever finishes) is
            # discarded.
            ylog.info("watchdog: inference exceeded "
                      f"{ms:.0f} ms; attempting one re-dispatch "
                      "(yolo2_accel_linux.c:350-377 analog)")
            out = dispatch()
            if out is None:
                raise TimeoutError(
                    f"inference exceeded YOLO2_LAYER_TIMEOUT_MS={ms:.0f} ms "
                    "twice (watchdog; recovery re-dispatch also timed out)")
            ylog.info("watchdog: recovery re-dispatch succeeded")
        self._seen_shapes.add(key)
        return out[0]

    def predict(self, boxed_chw: np.ndarray) -> PredictResult:
        """Run one letterboxed (3, H, W) float image; returns the raw region
        head in CHW (dump/parity layout)."""
        t0 = time.time()
        if self.backend == "xla":
            import jax.numpy as jnp
            x = jnp.asarray(boxed_chw.transpose(1, 2, 0)[None])
            head = self._guarded(
                lambda v: np.asarray(self._fn(v)["head"]), x)[0].transpose(2, 0, 1)
        else:
            if self.precision == "int16":
                mode = "exact" if self.compute == "exact" else "int32"
                acts = self._golden.forward_int16(boxed_chw, self.store.int16,
                                                  self.store.qtables, mode=mode)
            elif self.precision == "int8":
                acts = self._golden.forward_int16(boxed_chw, self.store.int8,
                                                  self.store.qtables8,
                                                  mode="int8")
            elif self.precision == "w8a16":
                acts = self._golden.forward_int16(boxed_chw,
                                                  self.store.w8a16,
                                                  self.store.qtables_w8,
                                                  mode="w8a16")
            else:
                acts = self._golden.forward_fp32(boxed_chw, self.store.fp32)
            head = acts[self.spec.n - 1]
        return PredictResult(head_chw=np.ascontiguousarray(head),
                             seconds=time.time() - t0)

    # ------------------------------------------------------------------
    def predict_layers(self, boxed_chw: np.ndarray) -> dict[int, np.ndarray]:
        """Debug forward returning EVERY layer's output in CHW (the
        user-facing analog of the reference cosim's per-layer dumps,
        vitis/yolo2_cosim_tb.cpp:970-979). golden backend: keep_all acts;
        xla backend: a separately-jitted debug build (outputs=('acts',)),
        compiled on first use."""
        if self.backend == "golden":
            if self.precision == "int16":
                mode = "exact" if self.compute == "exact" else "int32"
                acts = self._golden.forward_int16(
                    boxed_chw, self.store.int16, self.store.qtables,
                    keep_all=True, mode=mode)
            elif self.precision == "int8":
                acts = self._golden.forward_int16(
                    boxed_chw, self.store.int8, self.store.qtables8,
                    keep_all=True, mode="int8")
            elif self.precision == "w8a16":
                acts = self._golden.forward_int16(
                    boxed_chw, self.store.w8a16, self.store.qtables_w8,
                    keep_all=True, mode="w8a16")
            else:
                acts = self._golden.forward_fp32(boxed_chw, self.store.fp32,
                                                 keep_all=True)
            return {i: np.asarray(a) for i, a in acts.items()}
        import jax
        import jax.numpy as jnp
        if not hasattr(self, "_dbg_fn"):
            from ..models import yolov2 as m
            qt = (self.store.qtables if self.precision == "int16"
                  else self.store.qtables8 if self.precision == "int8"
                  else self.store.qtables_w8 if self.precision == "w8a16"
                  else None)
            fwd = m.build_forward(self.spec, self.precision, qt,
                                  self.compute, outputs=("acts",))
            dbg = jax.jit(fwd)
            self._dbg_fn = lambda x: dbg(self._params, x)
        x = jnp.asarray(boxed_chw.transpose(1, 2, 0)[None])
        out = self._guarded(
            lambda v: {k: np.asarray(a) for k, a in
                       self._dbg_fn(v)["acts"].items()}, x, tag="debug")
        return {int(k[5:]): a[0].transpose(2, 0, 1) for k, a in out.items()}

    def dump_layers(self, boxed_chw: np.ndarray, dirpath: str) -> None:
        """Write layerNN.bin per layer (raw CHW, exact c*h*w elements,
        native dtype — int16/int8/f32 by tier; no arena row alignment)."""
        os.makedirs(dirpath, exist_ok=True)
        acts = self.predict_layers(boxed_chw)
        for idx, a in sorted(acts.items()):
            np.ascontiguousarray(a).tofile(
                os.path.join(dirpath, f"layer{idx:02d}.bin"))
        ylog.info(f"dumped {len(acts)} layer tensors to {dirpath}")

    # ------------------------------------------------------------------
    def predict_batch(self, boxed_nchw: np.ndarray) -> np.ndarray:
        """Batched device inference: (N, 3, H, W) letterboxed frames ->
        (N, oc, h, w) raw heads. XLA path only (the batched streaming feed)."""
        if self.backend != "xla":
            return np.stack([self.predict(b).head_chw for b in boxed_nchw])
        import jax.numpy as jnp
        x = jnp.asarray(boxed_nchw.transpose(0, 2, 3, 1))
        return self._guarded(
            lambda v: np.asarray(self._fn(v)["head"]), x).transpose(0, 3, 1, 2)

    def predict_batch_rgb(self, frames_nhwc_u8: np.ndarray) -> np.ndarray:
        """Batched inference on net-sized uint8 RGB frames: the /255
        normalization runs on device, so the host->device transfer is uint8
        (4x smaller)."""
        if self.backend != "xla":
            boxed = frames_nhwc_u8.astype(np.float32).transpose(0, 3, 1, 2) / 255.0
            return self.predict_batch(boxed)
        import jax.numpy as jnp
        x = jnp.asarray(np.ascontiguousarray(frames_nhwc_u8))
        return self._guarded(
            lambda v: np.asarray(self._fn(v)["head"]), x).transpose(0, 3, 1, 2)

    def predict_batch_raw_frames(self, frames_nhwc_u8: np.ndarray):
        """Batched inference on RAW (non-net-sized) uint8 frames: the
        darknet-exact letterbox runs ON DEVICE (ops/letterbox.py), so only
        raw uint8 pixels cross the host->device link. One jit per source
        shape (camera/video sources have a fixed frame size).

        Returns the head array, or the top-K detection tuple when the
        engine was built with device_nms=True."""
        import jax
        import jax.numpy as jnp
        from ..ops.letterbox import device_letterbox
        key = frames_nhwc_u8.shape
        fn = self._lbox_fns.get(key)
        if fn is None:
            net_w, net_h = self.spec.net.width, self.spec.net.height

            def full(params, frames):
                boxed = device_letterbox(frames, net_w, net_h)
                return self._fwd(params, boxed)
            jitted = jax.jit(full)
            fn = self._lbox_fns[key] = (
                lambda v: jitted(self._params, v))
        out = self._guarded(
            lambda v: {k: np.asarray(o) for k, o in fn(v).items()},
            jnp.asarray(np.ascontiguousarray(frames_nhwc_u8)))
        if self.device_nms:
            self._warn_saturated(out)
            return (out["det_boxes"], out["det_scores"],
                    out["det_classes"], out["det_valid"])
        return out["head"].transpose(0, 3, 1, 2)

    def predict_batch_detections(self, frames) -> tuple:
        """Batched device decode+NMS (engine built with device_nms=True):
        only the fixed top-K tables leave the device — KBs per batch.
        frames: (N,H,W,3) uint8 or (N,3,H,W) f32."""
        if not self.device_nms:
            raise ValueError("engine built without device_nms=True")
        import jax.numpy as jnp
        if frames.dtype == np.uint8:
            x = jnp.asarray(np.ascontiguousarray(frames))
        else:
            x = jnp.asarray(frames.transpose(0, 2, 3, 1))
        out = self._guarded(
            lambda v: {k: np.asarray(o) for k, o in self._fn(v).items()}, x)
        self._warn_saturated(out)
        return (out["det_boxes"], out["det_scores"],
                out["det_classes"], out["det_valid"])

    def _warn_saturated(self, out: dict) -> None:
        """Device NMS truncation telemetry: more above-threshold candidates
        than top-K means the host path (which considers all h*w*n boxes,
        yolo_post.cpp:54-85) could return different detections."""
        sat = out.get("det_saturated")
        if sat is not None and np.any(sat):
            ylog.info(f"device NMS top-K saturated on "
                      f"{int(np.sum(sat))} frame(s); results may be "
                      "truncated (raise --topk)")

    def detections_from_topk(self, sb, ss, sc, sv, im_w: int,
                             im_h: int) -> list[Detection]:
        """One frame's top-K table -> host Detection list (letterbox-inverse
        box correction on the few surviving boxes)."""
        from ..postprocess import correct_region_boxes
        keep = sv & (ss > 0)
        classes = self.spec.region.classes
        if not keep.any():
            return []
        boxes = correct_region_boxes(sb[keep], im_w, im_h,
                                     self.spec.net.width,
                                     self.spec.net.height)
        dets = []
        for b, s, c in zip(boxes, ss[keep], sc[keep]):
            prob = np.zeros(classes, np.float32)
            prob[int(c)] = s
            dets.append(Detection(bbox=tuple(float(v) for v in b),
                                  objectness=float(s), prob=prob,
                                  classes=classes))
        return dets

    # ------------------------------------------------------------------
    def detect_device(self, image_chw: np.ndarray) -> tuple[list[Detection], float]:
        """On-device decode + class-wise NMS: only the fixed top-K table is
        read back (a few KB vs the 287 KB head). Thresholds were baked at
        engine construction (device_nms=True)."""
        if not self.device_nms:
            raise ValueError("engine built without device_nms=True")
        import jax.numpy as jnp
        from ..image import letterbox_image
        net_w, net_h = self.spec.net.width, self.spec.net.height
        boxed = letterbox_image(image_chw, net_w, net_h)
        t0 = time.time()
        out = self._guarded(
            lambda v: {k: np.asarray(o) for k, o in self._fn(v).items()},
            jnp.asarray(boxed.transpose(1, 2, 0)[None]))
        self._warn_saturated(out)
        sb, ss = out["det_boxes"][0], out["det_scores"][0]
        sc, sv = out["det_classes"][0], out["det_valid"][0]
        seconds = time.time() - t0
        dets = self.detections_from_topk(sb, ss, sc, sv,
                                         image_chw.shape[2],
                                         image_chw.shape[1])
        return dets, seconds

    # ------------------------------------------------------------------
    def detect(self, image_chw: np.ndarray, thresh: float = 0.25,
               nms: float = 0.45) -> tuple[list[Detection], PredictResult]:
        """Full pipeline on an original (unletterboxed) image."""
        from ..image import letterbox_image
        net_w, net_h = self.spec.net.width, self.spec.net.height
        boxed = letterbox_image(image_chw, net_w, net_h)
        res = self.predict(boxed)
        raw_flat = res.head_chw.reshape(-1)
        maybe_dump_region(raw_flat, raw=True)
        act = forward_region(raw_flat, self.spec.region)
        maybe_dump_region(act, raw=False)
        dets = get_region_detections(act, self.spec.region,
                                     im_w=image_chw.shape[2],
                                     im_h=image_chw.shape[1],
                                     net_w=net_w, net_h=net_h, thresh=thresh)
        dets = do_nms_sort(dets, self.spec.region.classes, nms)
        return dets, res


def maybe_dump_region(values: np.ndarray, raw: bool) -> None:
    """Region tensor text dumps, env-compatible with the reference
    (``yolo2_model.cpp:426-439``, ``yolov2_main.cpp:297-306``): one float per
    line, '%.9g'; disabled by YOLO2_NO_DUMP; paths via YOLO2_DUMP_REGION_RAW
    / YOLO2_DUMP_REGION; defaults yolov2_region_{raw,proc}_cpu.txt."""
    nd = os.environ.get("YOLO2_NO_DUMP", "")
    if nd and nd != "0":
        return
    if raw:
        path = (os.environ.get("YOLO2_DUMP_REGION_RAW_CPU")
                or os.environ.get("YOLO2_DUMP_REGION_RAW")
                or "yolov2_region_raw_cpu.txt")
    else:
        path = (os.environ.get("YOLO2_DUMP_REGION")
                or "yolov2_region_proc_cpu.txt")
    try:
        with open(path, "w") as f:
            for v in values:
                f.write(f"{v:.9g}\n")
        print(f"Dumped {values.size} floats to {path}")
    except OSError as e:
        ylog.error(f"Warning: cannot open dump file {path}: {e}")


# ---------------------------------------------------------------------------
# Weight acquisition helpers (artifact contract or synthetic)
# ---------------------------------------------------------------------------

def load_or_synthesize(spec: NetworkSpec, weights_dir: str | None,
                       precision: str, synthetic: bool = False,
                       seed: int = 0,
                       calib_images: list[np.ndarray] | None = None) -> WeightStore:
    """Load the reference .bin artifact set from ``weights_dir`` or build a
    synthetic store (with on-the-fly Q calibration for int16)."""
    if not synthetic and weights_dir:
        if precision == "int16":
            wp = _first_existing(weights_dir, ["weights_reorg_int16.bin",
                                               "weight_int16.bin"])
            reorg = wp.endswith("weights_reorg_int16.bin")
            return WeightStore.load_int16(
                spec, wp, os.path.join(weights_dir, "bias_int16.bin"),
                weights_dir, reorg=reorg)
        wp = _first_existing(weights_dir, ["weights_reorg.bin", "weights.bin"])
        reorg = wp.endswith("weights_reorg.bin")
        return WeightStore.load_fp32(
            spec, wp, os.path.join(weights_dir, "bias.bin"), reorg=reorg)

    ylog.info(f"using synthetic weights (seed={seed})")
    store = WeightStore.synthetic(spec, seed=seed)
    if precision in ("int16", "int8", "w8a16"):
        if calib_images is None:
            rng = np.random.default_rng(seed)
            calib_images = [rng.random(
                (spec.net.channels, spec.net.height, spec.net.width)
            ).astype(np.float32)]
        act_q = calibrate_activations(spec, store, calib_images)
        quantize_weights(store, act_q)
        if precision == "int8":
            # int8 activations calibrate at their own margin (1.4, not the
            # int16 tier's 2.0 — see quant.calibrate_activations_int8)
            from ..quant import (calibrate_activations_int8,
                                 quantize_weights_int8)
            act_q8 = calibrate_activations_int8(spec, store, calib_images)
            quantize_weights_int8(store, act_q8)
        elif precision == "w8a16":
            from ..quant import quantize_weights_w8a16
            quantize_weights_w8a16(store, act_q)
    return store


def _first_existing(dirpath: str, names: list[str]) -> str:
    for n in names:
        p = os.path.join(dirpath, n)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"none of {names} found in {dirpath}")
