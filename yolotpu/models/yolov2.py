"""YOLOv2-family forward builder: the whole cfg graph as ONE jitted program.

Where the reference drives 32 separate accelerator launches through a DDR
ping-pong arena (``yolo2_model.cpp:294-446``, ``yolo2_inference.c:763-910``),
here the entire network — input quantization, every conv/pool/reorg/route,
and the region head decode — traces into a single XLA computation: layer
"launch" overhead disappears, activations never leave HBM, and XLA fuses the
requantize/leaky chains into the convs.

Q routing is derived from the graph (a static ``Int16Plan``), not from
hard-coded layer indices like the reference (``yolo2_model.cpp:79-110``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..graph import (ConvSpec, MaxPoolSpec, NetworkSpec, RegionSpec,
                     ReorgSpec, RouteSpec)
from ..ops import convops, pool, region, reorg
from ..weights import QTables, WeightStore

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def params_fp32(spec: NetworkSpec, store: WeightStore) -> dict:
    """(n,c,k,k) darknet weights -> HWIO jnp trees keyed 'conv{idx}'."""
    p = {}
    for l in spec.conv_layers():
        w, b = store.fp32[l.idx]
        p[f"conv{l.idx}"] = {
            "w": jnp.asarray(w.transpose(2, 3, 1, 0)),  # (k,k,cin,cout)
            "b": jnp.asarray(b),
        }
    return p


def params_int16(spec: NetworkSpec, store: WeightStore) -> dict:
    """int16 HWIO weights + biases pre-shifted into each layer's Qa_out
    domain (the HLS core does the same shift once per tile,
    core_compute.cpp:49-63,86-96; here it happens once at load)."""
    if store.qtables is None:
        raise ValueError("int16 params require Q tables")
    return _params_quantized(spec, store.int16, store.qtables)


def params_int8(spec: NetworkSpec, store: WeightStore) -> dict:
    """w8a8 turbo tier parameters (int8 HWIO weights, pre-shifted bias)."""
    if store.qtables8 is None:
        raise ValueError("int8 params require Q tables (quantize_weights_int8)")
    return _params_quantized(spec, store.int8, store.qtables8)


def params_w8a16(spec: NetworkSpec, store: WeightStore) -> dict:
    """w8a16 tier parameters: per-channel int8 weights (HWIO), the
    activation lo-plane correction ``cw``, and the pre-shifted bias."""
    from ..ops.convops import prep_weights_w8a16
    if store.qtables_w8 is None:
        raise ValueError("w8a16 params require Q tables "
                         "(quant.quantize_weights_w8a16)")
    p = _params_quantized(spec, store.w8a16, store.qtables_w8)
    for pw in p.values():
        pw["cw"] = jnp.asarray(prep_weights_w8a16(np.asarray(pw["w"])))
    return p


def _params_quantized(spec: NetworkSpec, wdict, qt: QTables) -> dict:
    plan = Int16Plan.build(spec, qt)
    p = {}
    for ci, l in enumerate(spec.conv_layers()):
        w, b = wdict[l.idx]
        shift_bias = qt.bias_q[ci] - plan.conv_qa_out[l.idx]
        bias_shifted = _round_shift_np(b.astype(np.int64), shift_bias)
        p[f"conv{l.idx}"] = {
            "w": jnp.asarray(w.transpose(2, 3, 1, 0)),
            "b": jnp.asarray(bias_shifted.astype(np.int32)),
        }
    return p


def _round_shift_np(v: np.ndarray, shift) -> np.ndarray:
    if np.ndim(shift) == 0:
        shift = int(shift)
        if shift > 0:
            mag = min(shift, 30)
            return (v + (1 << (mag - 1))) >> mag
        if shift < 0:
            return v << min(-shift, 30)
        return v
    # per-channel bias Q (int8 per-channel tier): elementwise shift
    s = np.clip(np.asarray(shift, np.int64), -30, 30)
    half = np.where(s > 0, np.int64(1) << np.maximum(s - 1, 0), np.int64(0))
    return np.where(s > 0, (v + half) >> np.maximum(s, 0),
                    v << np.maximum(-s, 0))


# ---------------------------------------------------------------------------
# Static INT16 scale plan (graph-derived Q routing)
# ---------------------------------------------------------------------------

@dataclass
class Int16Plan:
    """Per-layer quantization routing, resolved at build time.

    Mirrors the reference sequencer's runtime bookkeeping
    (``yolo2_model.cpp:288-340,379-399``): conv input/output Qs from the
    iofm table, the reorg branch realignment shift, and the pending route Q
    override for the conv after a concat.
    """

    conv_qa_in: dict[int, int] = field(default_factory=dict)
    conv_qa_out: dict[int, int] = field(default_factory=dict)
    conv_shift_out: dict[int, int] = field(default_factory=dict)
    reorg_realign: dict[int, int] = field(default_factory=dict)  # idx -> shift
    layer_q: dict[int, int] = field(default_factory=dict)        # output q per layer
    input_q: int = 0
    output_q: int = 0

    @classmethod
    def build(cls, spec: NetworkSpec, qt: QTables) -> "Int16Plan":
        plan = cls(input_q=qt.act_q[0])
        cur_q = qt.act_q[0]
        conv_i = 0
        pending: int | None = None
        for l in spec.layers:
            if isinstance(l, ConvSpec):
                qa_in = qt.act_q[conv_i] if pending is None else pending
                qa_out = qt.act_q[conv_i + 1]
                plan.conv_qa_in[l.idx] = qa_in
                plan.conv_qa_out[l.idx] = qa_out
                plan.conv_shift_out[l.idx] = qa_in + qt.weight_q[conv_i] - qa_out
                cur_q = qa_out
                conv_i += 1
                pending = None
            elif isinstance(l, ReorgSpec):
                sib_q = _sibling_route_q(spec, l.idx, plan.layer_q)
                if sib_q is not None and sib_q > 0:
                    target = min(sib_q, cur_q)
                    plan.reorg_realign[l.idx] = cur_q - target
                    cur_q = target
                    pending = cur_q
            elif isinstance(l, RouteSpec):
                if len(l.layers) == 1:
                    cur_q = plan.layer_q[l.layers[0]]
                elif pending is None:
                    cur_q = plan.layer_q[l.layers[0]]
                    pending = cur_q
                else:
                    cur_q = pending
            plan.layer_q[l.idx] = cur_q
        plan.output_q = cur_q
        return plan


def _sibling_route_q(spec: NetworkSpec, reorg_idx: int,
                     layer_q: dict[int, int]) -> int | None:
    for l in spec.layers:
        if isinstance(l, RouteSpec) and reorg_idx in l.layers and len(l.layers) > 1:
            for s in l.layers:
                if s != reorg_idx and s in layer_q:
                    return layer_q[s]
    return None


# ---------------------------------------------------------------------------
# Forward builder
# ---------------------------------------------------------------------------

def build_forward(spec: NetworkSpec, precision: str = "fp32",
                  qtables: QTables | None = None, compute: str = "int32",
                  outputs: tuple[str, ...] = ("head", "boxes"),
                  debug: bool = False, thresh: float = 0.25,
                  nms_thresh: float = 0.45, topk: int = 256,
                  mesh=None):
    """Return ``forward(params, x)`` for the given graph.

    x: (B, H, W, 3) float32 NHWC, already letterboxed to the net dims.
    outputs (any of):
      "head"       — dequantized raw region input (B, h, w, oc) fp32
      "boxes"      — decoded (boxes, obj, probs) fixed-shape tensors
      "detections" — on-device thresholded class-wise NMS: fixed top-K
                     (sel_boxes, sel_scores, sel_classes, sel_valid) —
                     only KBs leave the device per frame
      "acts"       — every layer's output (debug; forces debug=True)
    """
    if "acts" in outputs:
        debug = True
    region_spec = spec.region
    plan: Int16Plan | None = None
    if precision in ("int16", "int8", "w8a16"):
        if qtables is None:
            raise ValueError(f"{precision} forward requires Q tables")
        plan = Int16Plan.build(spec, qtables)
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r}")
    is_int8 = precision == "int8"
    is_w8a16 = precision == "w8a16"

    needed = {s for l in spec.layers if isinstance(l, RouteSpec) for s in l.layers}

    def _batch_only(v):
        """Constrain to batch(dp)-only sharding at shape-shuffling
        boundaries. The reorg's flat channel<->space reinterpretation defeats
        GSPMD propagation from tp(channel)-sharded producers — without the
        constraint the partitioner falls back to 'involuntary full
        rematerialization'. An explicit all-gather here is the efficient
        form of the same data movement."""
        if mesh is None:
            return v
        from jax.sharding import NamedSharding, PartitionSpec
        spec_ = PartitionSpec("dp", *([None] * (v.ndim - 1)))
        return jax.lax.with_sharding_constraint(
            v, NamedSharding(mesh, spec_))

    def forward(params: dict, x: jnp.ndarray) -> dict:
        acts: dict[int, jnp.ndarray] = {}
        all_acts: dict[str, jnp.ndarray] = {}

        if x.dtype == jnp.uint8:
            # uint8 frames upload 4x cheaper; /255 on device is bit-identical
            # to the host loader's f32 division (yolo2_image_loader.c:34-80)
            x = x.astype(jnp.float32) / 255.0
        if plan is not None:
            cur = (convops.quantize_input_int8(x, plan.input_q) if is_int8
                   else convops.quantize_input_int16(x, plan.input_q))
        else:
            cur = x.astype(jnp.float32)
        head = None

        for l in spec.layers:
            if isinstance(l, ConvSpec):
                pw = params[f"conv{l.idx}"]
                if plan is None:
                    cur = convops.conv_fp32(cur, pw["w"], pw["b"], l.stride,
                                            l.pad, l.activation)
                elif is_int8:
                    # the conv feeding the region head emits int16 logits
                    # at an 8-bits-finer scale (head16, see conv_int8)
                    head16 = (region_spec is not None
                              and l.idx + 1 == region_spec.idx)
                    cur = convops.conv_int8(
                        cur, pw["w"], pw["b"], l.stride, l.pad,
                        l.activation, plan.conv_shift_out[l.idx],
                        head16=head16)
                elif is_w8a16:
                    cur = convops.conv_w8a16(
                        cur, pw["w"], pw["cw"], pw["b"], l.stride, l.pad,
                        l.activation, plan.conv_shift_out[l.idx])
                else:
                    cur = convops.conv_int16(cur, pw["w"], pw["b"], l.stride,
                                             l.pad, l.activation,
                                             plan.conv_shift_out[l.idx],
                                             compute=compute)
            elif isinstance(l, MaxPoolSpec):
                cur = pool.maxpool(cur, l.size, l.stride, l.padding)
            elif isinstance(l, ReorgSpec):
                cur = _batch_only(reorg.reorg(_batch_only(cur), l.stride))
                if plan is not None:
                    sh = plan.reorg_realign.get(l.idx, 0)
                    if sh != 0:
                        cur = convops.realign_int16(cur, sh)
            elif isinstance(l, RouteSpec):
                cur = (acts[l.layers[0]] if len(l.layers) == 1 else
                       _batch_only(jnp.concatenate(
                           [acts[s] for s in l.layers], axis=-1)))
            elif isinstance(l, RegionSpec):
                head = (convops.dequantize_int16(
                            cur, plan.output_q + (8 if is_int8 else 0))
                        if plan is not None else cur)
                cur = head
            if l.idx in needed or debug:
                acts[l.idx] = cur
            if debug:
                all_acts[f"layer{l.idx}"] = cur

        out: dict = {}
        if head is None:   # headless graphs (e.g. backbone-only tests)
            head = (cur if plan is None
                    else convops.dequantize_int16(cur, plan.output_q))
        if "head" in outputs:
            out["head"] = head
        if (("boxes" in outputs) or ("detections" in outputs)) \
                and region_spec is not None:
            boxes, obj, probs = region.decode_region(head, region_spec)
            if "boxes" in outputs:
                out["boxes"], out["obj"], out["probs"] = boxes, obj, probs
            if "detections" in outputs:
                from ..ops import nms as nms_ops
                sb, ss, sc, sv, sat = nms_ops.topk_decode_nms(
                    boxes, obj, probs, thresh, nms_thresh, topk)
                out["det_boxes"], out["det_scores"] = sb, ss
                out["det_classes"], out["det_valid"] = sc, sv
                out["det_saturated"] = sat
        if debug:
            out["acts"] = all_acts
        return out

    return forward

