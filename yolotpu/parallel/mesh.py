"""Device mesh + sharding policies for multi-chip inference/training.

The reference's only parallelism is a 32x4 MAC array and AXI DMA double
buffering (SURVEY §2 parallelism table); a multi-GPU host's axes are
different in kind. This module maps the framework onto a 2-D ``(dp, tp)`` mesh:

- ``dp`` (data parallel): the batch dimension — inference streams shard
  frames across chips; collectives-free until the host gathers detections.
- ``tp`` (tensor parallel): conv output channels — weights shard on Cout
  (HWIO axis 3) and activations on the channel axis; XLA/GSPMD inserts the
  halo-free all-gathers/reduce-scatters where channel-sharded activations
  feed the next conv. Useful when a model outgrows one chip's HBM; for
  YOLOv2 (97 MiB int16) it exists to prove the plumbing at framework scale.

Shardings are expressed as `jax.sharding.NamedSharding` on the param/batch
pytrees and propagated by GSPMD — no hand-written collectives.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def factor_mesh(n_devices: int) -> tuple[int, int]:
    """Split n into (dp, tp): prefer tp in {1,2,4} and maximize dp."""
    for tp in (4, 2, 1):
        if n_devices % tp == 0 and tp <= n_devices:
            return n_devices // tp, tp
    return n_devices, 1


def make_mesh(n_devices: int | None = None,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_devices or len(devices)
    dp, tp = factor_mesh(n)
    arr = np.array(devices[:n]).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))


def param_shardings(params: dict, mesh: Mesh) -> dict:
    """Shard each layer's arrays on Cout, their last axis (HWIO weights,
    biases, the w8a16 correction), over tp; replicate over dp. Layers whose
    Cout is not divisible by the tp extent (e.g. the 425-channel head conv)
    stay replicated.
    """
    tp = mesh.shape["tp"]
    out = {}
    for name, p in params.items():
        shard = tp > 1 and p["w"].shape[3] % tp == 0
        out[name] = {
            k: NamedSharding(mesh, P(*([None] * (v.ndim - 1)), "tp")
                             if shard else P())
            for k, v in p.items()}
    return out


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """NHWC batch: shard N over dp, replicate spatial/channels."""
    return NamedSharding(mesh, P("dp", None, None, None))


def make_mesh_sp(n_devices: int | None = None, devices=None,
                 sp: int | None = None) -> Mesh:
    """(dp, sp) mesh for SPATIALLY partitioned inference: activations
    shard on the H dimension and GSPMD materializes the conv/pool halo
    exchanges (`collective-permute` of the one-row overlap per 3x3 conv).
    The conv-net analog of sequence parallelism: it serves inputs whose
    activations outgrow one chip's HBM (e.g. megapixel frames at the
    entry stage, where YOLOv2's 416x416x32 int16 activation is 11 MiB but
    a 4Kx4K frame's would be 1 GiB) without touching the model code —
    int32-accum convs are deterministic, so a spatially-sharded run is
    bit-equal to the replicated one (tests/test_spatial_sharding.py).

    ``sp`` defaults to the largest power of two <= n that keeps H
    divisibility practical (callers pick sp to divide their sharded H)."""
    devices = devices if devices is not None else jax.devices()
    n = n_devices or len(devices)
    if sp is None:
        # cap sp at 4: deep layers shrink H (416 -> 13), and each extra sp
        # shard adds a halo row per 3x3 conv — beyond 4 ways the halo
        # overhead dominates before HBM pressure ever does
        sp = 1
        while sp * 2 <= 4 and n % (sp * 2) == 0:
            sp *= 2
    dp = n // sp
    arr = np.array(devices[:n]).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


def spatial_batch_sharding(mesh: Mesh) -> NamedSharding:
    """NHWC batch on a (dp, sp) mesh: N over dp, H over sp."""
    return NamedSharding(mesh, P("dp", "sp", None, None))


def shard_params(params: dict, mesh: Mesh) -> dict:
    sh = param_shardings(params, mesh)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), params, sh,
        is_leaf=lambda x: not isinstance(x, dict))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
