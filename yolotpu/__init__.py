"""yolotpu — a YOLOv2 INT16 detection framework in JAX/XLA.

A from-scratch rebuild of the capabilities of the reference FPGA stack
(solomontesema/yolo-fpga-accelerator) re-designed for an XLA accelerator:

- darknet ``.cfg`` graphs are parsed into a typed layer list and traced into
  ONE jitted XLA program (the reference launches 32 separate accelerator
  calls; see reference ``hls/models/yolov2/yolo2_model.cpp:294-446``).
- INT16 quantization with per-layer power-of-two Q tables follows the
  reference artifact contract (``weights/README.md``, ``yolo2_model.cpp:158-227``)
  with convolution accumulating exactly in int32 on integer GEMMs.
- Postprocess (region decode, class-wise NMS, letterbox inverse) matches the
  darknet host reference (``src/core/yolo_region.cpp``, ``yolo_post.cpp``).

Public entry points:
    yolotpu.graph.NetworkSpec.from_cfg(path)   — parse a darknet cfg
    yolotpu.weights.WeightStore                — load/generate weight artifacts
    yolotpu.models.yolov2.build_forward(...)   — jitted device forward
    yolotpu.golden.GoldenNet                   — numpy fp32/int16 oracle
    yolotpu.cli.detect                         — `yolov2_detect`-compatible CLI
"""

__version__ = "0.1.0"
