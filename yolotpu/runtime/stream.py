"""Streaming inference orchestrator (camera/video modes).

Re-design of the board app's streaming loops (``linux_app/src/main.c:
877-1288``): frames -> ``--infer-every`` decimation -> letterbox -> device ->
region decode -> NMS -> sinks (JSONL, annotated PNGs, MJPEG push, stdout).

Pipelining: JAX dispatch is asynchronous, so the loop runs one step ahead —
while frame N executes on the device, frame N-1's head is read back and
postprocessed on host. This is the XLA-era equivalent of the reference's
double-buffered DMA/compute overlap (``hls/core/core_scheduler.cpp:33-61``).

A watchdog bounds each device step (env ``YOLO2_LAYER_TIMEOUT_MS``, default
60000 like ``linux_app/include/yolo2_config.h:141``): a device step that
exceeds it raises instead of hanging the stream forever.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from dataclasses import dataclass, field

import numpy as np

from ..postprocess import do_nms_sort, forward_region, get_region_detections
from . import logging as ylog
from .profiler import StepTimer


@dataclass
class StreamConfig:
    thresh: float = 0.25
    nms: float = 0.45
    infer_every: int = 1
    max_frames: int = 0          # 0 = unlimited (EOF-bound)
    batch_size: int = 1          # >1: double-buffered batched device feed
    save_annotated_dir: str | None = None
    output_json: str | None = None
    mjpeg_port: int | None = None
    mjpeg_bind: str = "0.0.0.0"
    mjpeg_fps: int = 15
    mjpeg_quality: int = 80
    mode: str = "video"
    source: str = ""
    labels: list[str] = field(default_factory=list)


def _watchdog_ms() -> float:
    try:
        return float(os.environ.get("YOLO2_LAYER_TIMEOUT_MS", "60000"))
    except ValueError:
        return 60000.0


class StreamRunner:
    def __init__(self, engine, cfg: StreamConfig):
        self.engine = engine
        self.cfg = cfg
        self.timer = StepTimer()
        self._jsonl = None
        self._mjpeg = None
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        from .. import native
        self._native = native.available()
        if cfg.output_json:
            from .jsonl import JsonlWriter
            self._jsonl = JsonlWriter(cfg.output_json)
        if cfg.mjpeg_port is not None:
            from .mjpeg import MjpegStreamer
            self._mjpeg = MjpegStreamer(cfg.mjpeg_port, cfg.mjpeg_bind,
                                        cfg.mjpeg_fps, cfg.mjpeg_quality)
            ylog.info(f"MJPEG stream on http://{cfg.mjpeg_bind}:{self._mjpeg.port}/")

    # ------------------------------------------------------------------
    def _read_frame(self, frame_source):
        """Mode-aware frame read. In camera mode a failed read is a
        transient decode/driver hiccup — skip it and keep streaming, like
        the board app (main.c:972-974 continues on decode failure) — up to
        a bounded consecutive-failure budget (env YOLO2_READ_RETRIES,
        default 30) treated as a dead camera. In video/image modes a None
        read is EOF (main.c:1135-1141) and ends the stream."""
        frame = frame_source.read()
        if frame is not None or self.cfg.mode != "camera":
            return frame
        try:
            budget = int(os.environ.get("YOLO2_READ_RETRIES", "30"))
        except ValueError:
            budget = 30
        # Retry at roughly frame cadence, like the board app whose loop is
        # paced by the V4L2 dequeue: a fast-failing (non-blocking) source
        # must not burn the whole budget in microseconds on one transient
        # hiccup. ~33 ms default; sources with their own blocking read are
        # unaffected beyond the small extra sleep.
        try:
            delay_s = float(os.environ.get("YOLO2_READ_RETRY_MS", "33")) / 1e3
        except ValueError:
            delay_s = 0.033
        for attempt in range(budget):
            ylog.debug(f"camera read failed; skipping frame "
                       f"(retry {attempt + 1}/{budget})")
            if delay_s > 0:
                time.sleep(delay_s)
            frame = frame_source.read()
            if frame is not None:
                return frame
        ylog.info(f"camera: {budget} consecutive failed reads; stopping")
        return None

    def run(self, frame_source) -> dict:
        """Consume HWC uint8 RGB frames from ``frame_source.read()`` until
        EOF or max_frames inferences. Returns the timing summary."""
        if self.cfg.batch_size > 1:
            return self._run_batched(frame_source)
        from ..image import letterbox_image

        cfg = self.cfg
        net_w, net_h = self.engine.spec.net.width, self.engine.spec.net.height
        frame_idx = infer_idx = submitted = 0
        pending = None   # (future, frame, frame_idx, infer_idx, t0)
        deadline_ms = _watchdog_ms()

        while True:
            frame = self._read_frame(frame_source)
            if frame is None:
                break
            frame_idx += 1
            if (frame_idx - 1) % max(1, cfg.infer_every) != 0:
                continue   # --infer-every decimation (main.c:1143-1147)
            if cfg.max_frames and submitted >= cfg.max_frames:
                break
            submitted += 1

            needs_box = frame.shape[0] != net_h or frame.shape[1] != net_w
            if self._native:
                from .. import native
                chw = native.hwc_to_chw(frame)
                boxed = (native.frame_to_input(frame, net_w, net_h)
                         if needs_box else chw)
            else:
                chw = frame.astype(np.float32).transpose(2, 0, 1) / 255.0
                boxed = letterbox_image(chw, net_w, net_h) if needs_box else chw

            t0 = time.perf_counter()
            fut = self._pool.submit(self.engine.predict, boxed)
            if pending is not None:
                self._finish(*pending, deadline_ms)
                infer_idx += 1
            pending = (fut, frame, chw, frame_idx - 1, infer_idx, t0)

        if pending is not None:
            self._finish(*pending, deadline_ms)
            infer_idx += 1

        summary = self.timer.summary()
        if summary.get("count"):
            ylog.info(
                f"{summary['count']} inferences: mean {summary['mean_ms']:.2f} ms, "
                f"median {summary['median_ms']:.2f} ms, p90 {summary['p90_ms']:.2f} ms, "
                f"{summary['fps']:.1f} FPS")
        self.close()
        return summary

    # ------------------------------------------------------------------
    def _run_batched(self, frame_source) -> dict:
        """Double-buffered batched feed: accumulate ``batch_size`` frames,
        dispatch the batch, and postprocess batch k-1 on the host while
        batch k executes on the device (the reference's compute/transfer
        ping-pong, core_scheduler.cpp:33-61, at batch granularity)."""
        from ..image import letterbox_image
        cfg = self.cfg
        net_w = self.engine.spec.net.width
        net_h = self.engine.spec.net.height
        deadline_ms = _watchdog_ms()
        frame_idx = infer_idx = submitted = 0
        pending = None   # (future, frames, chws, idxs, t0)

        def collect():
            nonlocal frame_idx, submitted
            frames, chws, idxs = [], [], []
            while len(frames) < cfg.batch_size:
                frame = self._read_frame(frame_source)
                if frame is None:
                    break
                frame_idx += 1
                if (frame_idx - 1) % max(1, cfg.infer_every) != 0:
                    continue
                if cfg.max_frames and submitted >= cfg.max_frames:
                    break
                submitted += 1
                if frame.shape[:2] == (net_h, net_w) or \
                        self.engine.backend == "xla":
                    boxed = frame     # uint8 upload; letterbox/norm on device
                elif self._native:
                    from .. import native
                    boxed = native.frame_to_input(frame, net_w, net_h)
                else:
                    chw = frame.astype(np.float32).transpose(2, 0, 1) / 255.0
                    boxed = letterbox_image(chw, net_w, net_h)
                frames.append(frame)
                chws.append(boxed)
                idxs.append(frame_idx - 1)
            return frames, chws, idxs

        while True:
            frames, boxed, idxs = collect()
            if not frames:
                break
            t0 = time.perf_counter()
            stack = np.stack(boxed)
            if stack.shape[0] < cfg.batch_size:
                # pad the tail batch so the jitted shape stays constant
                pad = cfg.batch_size - stack.shape[0]
                stack = np.concatenate(
                    [stack, np.zeros((pad,) + stack.shape[1:], stack.dtype)])
            net_sized = stack.shape[1:3] == (self.engine.spec.net.height,
                                             self.engine.spec.net.width)
            if stack.dtype == np.uint8 and not net_sized:
                fut = self._pool.submit(self.engine.predict_batch_raw_frames,
                                        stack)
            elif getattr(self.engine, "device_nms", False):
                fut = self._pool.submit(self.engine.predict_batch_detections,
                                        stack)
            elif stack.dtype == np.uint8:
                fut = self._pool.submit(self.engine.predict_batch_rgb, stack)
            else:
                fut = self._pool.submit(self.engine.predict_batch, stack)
            # the first batch may include an XLA compile (shape/dtype not
            # covered by warmup); don't let the watchdog count compilation
            def _dl():
                return (max(deadline_ms, 900_000.0) if batches_done == 0
                        else deadline_ms)
            batches_done = getattr(self, "_batches_done", 0)
            if pending is not None:
                infer_idx = self._finish_batch(*pending, infer_idx, _dl())
                batches_done += 1
                self._batches_done = batches_done
            pending = (fut, frames, idxs, t0)
            if cfg.max_frames and submitted >= cfg.max_frames:
                break
        if pending is not None:
            batches_done = getattr(self, "_batches_done", 0)
            dl = (max(deadline_ms, 900_000.0) if batches_done == 0
                  else deadline_ms)
            infer_idx = self._finish_batch(*pending, infer_idx, dl)
        summary = self.timer.summary(frames_per_step=cfg.batch_size)
        if summary.get("count"):
            ylog.info(f"{infer_idx} inferences in {summary['count']} batches: "
                      f"p50 {summary['median_ms']:.2f} ms/batch, "
                      f"{summary['fps']:.1f} FPS")
        self.close()
        return summary

    def _finish_batch(self, fut, frames, idxs, t0, infer_idx,
                      deadline_ms) -> int:
        try:
            result = fut.result(timeout=deadline_ms / 1000.0)
        except concurrent.futures.TimeoutError:
            raise TimeoutError(
                f"batched inference exceeded YOLO2_LAYER_TIMEOUT_MS watchdog")
        self.timer.add((time.perf_counter() - t0) * 1e3)
        if isinstance(result, tuple):        # device-NMS top-K tables
            sb, ss, sc, sv = result
            for k, (frame, fidx) in enumerate(zip(frames, idxs)):
                dets = self.engine.detections_from_topk(
                    sb[k], ss[k], sc[k], sv[k], frame.shape[1], frame.shape[0])
                self._emit(dets, frame, None, fidx, infer_idx)
                infer_idx += 1
        else:
            for frame, fidx, head in zip(frames, idxs, result):
                self._postprocess(head, frame, None, fidx, infer_idx)
                infer_idx += 1
        return infer_idx

    # ------------------------------------------------------------------
    def _finish(self, fut, frame, chw, frame_idx, infer_idx, t0,
                deadline_ms) -> None:
        cfg = self.cfg
        try:
            res = fut.result(timeout=deadline_ms / 1000.0)
        except concurrent.futures.TimeoutError:
            raise TimeoutError(
                f"inference step exceeded YOLO2_LAYER_TIMEOUT_MS="
                f"{deadline_ms:.0f} ms (watchdog)")
        ms = (time.perf_counter() - t0) * 1e3
        self.timer.add(ms)
        ylog.layer(f"frame {frame_idx}: inference time: {ms:.2f} ms")
        self._postprocess(res.head_chw, frame, chw, frame_idx, infer_idx)

    # ------------------------------------------------------------------
    def _postprocess(self, head_chw, frame, chw, frame_idx, infer_idx) -> None:
        cfg = self.cfg
        act = forward_region(head_chw.reshape(-1), self.engine.spec.region)
        h, w = frame.shape[0], frame.shape[1]
        dets = get_region_detections(act, self.engine.spec.region,
                                     im_w=w, im_h=h,
                                     net_w=self.engine.spec.net.width,
                                     net_h=self.engine.spec.net.height,
                                     thresh=cfg.thresh)
        dets = do_nms_sort(dets, self.engine.spec.region.classes, cfg.nms)
        self._emit(dets, frame, chw, frame_idx, infer_idx)

    def _emit(self, dets, frame, chw, frame_idx, infer_idx) -> None:
        cfg = self.cfg
        h, w = frame.shape[0], frame.shape[1]
        if self._jsonl:
            self._jsonl.write_record(cfg.mode, cfg.source, frame_idx,
                                     infer_idx, w, h, dets, cfg.labels,
                                     cfg.thresh)
        if cfg.save_annotated_dir or self._mjpeg:
            from .drawing import draw_detections
            if chw is None:
                chw = frame.astype(np.float32).transpose(2, 0, 1) / 255.0
            drawn = draw_detections(chw, dets, cfg.labels, cfg.thresh)
            rgb = np.clip(drawn.transpose(1, 2, 0) * 255 + 0.5,
                          0, 255).astype(np.uint8)
            if cfg.save_annotated_dir:
                os.makedirs(cfg.save_annotated_dir, exist_ok=True)
                from ..image import save_rgb
                save_rgb(rgb, os.path.join(cfg.save_annotated_dir,
                                           f"frame_{infer_idx:06d}.png"))
            if self._mjpeg:
                self._mjpeg.update_rgb(rgb)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._mjpeg:
            self._mjpeg.stop()
            self._mjpeg = None
        self._pool.shutdown(wait=False)
