"""Per-layer profiler + timing reports.

Analog of the board's per-layer µs timing and top-10 latency table
(``linux_app/src/yolo2_inference.c:45-61,75-142,900-906``). The production
path is ONE fused XLA program, so per-layer numbers come from an
instrumented build: each layer compiled as its own jitted segment (or each
prefix of the program) and timed up to ``block_until_ready``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..graph import (ConvSpec, MaxPoolSpec, NetworkSpec, RegionSpec,
                     ReorgSpec, RouteSpec)


@dataclass
class LayerTiming:
    idx: int
    type: str
    ms: float
    detail: str = ""
    tops: float = 0.0    # achieved useful TOPS (2*MACs / time)
    gbs: float = 0.0     # achieved HBM traffic GB/s (acts in+out + weights)


def layer_ops_bytes(l, batch: int, elem_bytes: int = 2) -> tuple[float, float]:
    """(useful ops, minimal device-memory bytes) for one layer at the given
    batch — the analog of the reference report's DSP/BRAM utilization
    columns (scripts/yolo2_report.py csynth parsing): here utilization is
    achieved TOPS and achieved GB/s."""
    if isinstance(l, ConvSpec):
        ops = 2.0 * batch * l.out_h * l.out_w * l.n * (l.c // l.groups) \
            * l.size * l.size
        bytes_ = elem_bytes * (batch * (l.h * l.w * l.c
                                        + l.out_h * l.out_w * l.n)
                               + l.size * l.size * l.c * l.n)
        return ops, bytes_
    if isinstance(l, MaxPoolSpec):
        bytes_ = elem_bytes * batch * (l.h * l.w * l.c
                                       + l.out_h * l.out_w * l.c)
        return 0.0, bytes_
    if isinstance(l, ReorgSpec):
        return 0.0, 2 * elem_bytes * batch * l.h * l.w * l.c
    if isinstance(l, RouteSpec):
        return 0.0, 0.0
    return 0.0, 0.0


@dataclass
class ProfileReport:
    timings: list[LayerTiming] = field(default_factory=list)
    total_ms: float = 0.0

    def render(self) -> str:
        """Mirror the reference's summary: total, slowest, top-10 table —
        plus achieved TOPS / HBM GB/s per layer (utilization analog of the
        csynth DSP/LUT/BRAM table the reference report parses)."""
        lines = []
        total = sum(t.ms for t in self.timings)
        lines.append(f"Total layer time: {total:.3f} ms")
        top = sorted(self.timings, key=lambda t: -t.ms)[:10]
        lines.append("Top 10 slowest layers:")
        lines.append("  rank layer type           time(ms)   share"
                     "    TOPS   GB/s")
        for r, t in enumerate(top, 1):
            share = 100.0 * t.ms / total if total else 0.0
            lines.append(
                f"  {r:4d} {t.idx:5d} {t.type:14s} {t.ms:8.3f}  "
                f"{share:5.1f}%  {t.tops:6.1f} {t.gbs:6.0f}  {t.detail}")
        return "\n".join(lines)

    def as_dicts(self) -> list[dict]:
        return [{"idx": t.idx, "type": t.type, "ms": round(t.ms, 4),
                 "tops": round(t.tops, 2), "gbs": round(t.gbs, 1),
                 "detail": t.detail} for t in self.timings]


def profile_layers(spec: NetworkSpec, store, precision: str = "fp32",
                   compute: str = "int32", batch: int = 1,
                   repeats: int = 5, rng_seed: int = 0,
                   progress: bool = False) -> ProfileReport:
    """Time every layer as an isolated jitted segment on the default device."""
    import jax
    import jax.numpy as jnp

    from ..models import yolov2 as m
    from ..ops import convops, pool, reorg

    if precision == "int16":
        params = m.params_int16(spec, store)
        plan = m.Int16Plan.build(spec, store.qtables)
    else:
        params = m.params_fp32(spec, store)
        plan = None

    rng = np.random.default_rng(rng_seed)
    report = ProfileReport()

    # materialize layer inputs by running the graph once (host-side shapes)
    acts: dict[int, jnp.ndarray] = {}
    x = jnp.asarray(rng.random(
        (batch, spec.net.height, spec.net.width, spec.net.channels),
        dtype=np.float32))
    if plan is not None:
        cur = convops.quantize_input_int16(x, plan.input_q)
    else:
        cur = x

    # dispatch the op `chain` times on slightly distinct inputs (defeats any
    # caching of identical calls), wait for the last, divide
    chain = max(8, repeats)

    def timed(fn, *args) -> tuple[jnp.ndarray, float]:
        x0 = args[0]
        rest = args[1:]
        # bound live device memory: distinct inputs cost chain * x0.nbytes
        n = int(max(2, min(chain, (1 << 31) // max(x0.nbytes, 1))))
        one = jnp.ones((), x0.dtype)
        xs = [x0.at[(0,) * x0.ndim].add(one * i) for i in range(n)]
        jax.block_until_ready([fn(xi, *rest) for xi in xs])  # compile + warm
        ts = []
        for _i in range(3):
            t0 = time.perf_counter()
            out = None
            for xi in xs:
                out = fn(xi, *rest)
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        return fn(*args), float(np.median(ts)) * 1e3 / n

    import functools

    for l in spec.layers:
        detail = ""
        if isinstance(l, ConvSpec):
            pw = params[f"conv{l.idx}"]
            if plan is not None:
                fn = jax.jit(functools.partial(
                    convops.conv_int16, stride=l.stride, pad=l.pad,
                    activation=l.activation,
                    shift_out=plan.conv_shift_out[l.idx], compute=compute))
            else:
                fn = jax.jit(functools.partial(
                    convops.conv_fp32, stride=l.stride, pad=l.pad,
                    activation=l.activation))
            cur, ms = timed(fn, cur, pw["w"], pw["b"])
            detail = (f"{l.size}x{l.size}/{l.stride} {l.c}->{l.n} "
                      f"{l.bflops * batch:.2f} BFLOP")
        elif isinstance(l, MaxPoolSpec):
            fn = jax.jit(functools.partial(pool.maxpool, size=l.size,
                                           stride=l.stride, padding=l.padding))
            cur, ms = timed(fn, cur)
        elif isinstance(l, ReorgSpec):
            fn = jax.jit(functools.partial(reorg.reorg, stride=l.stride))
            cur, ms = timed(fn, cur)
            if plan is not None and plan.reorg_realign.get(l.idx, 0):
                cur = convops.realign_int16(cur, plan.reorg_realign[l.idx])
        elif isinstance(l, RouteSpec):
            srcs = [acts[s] for s in l.layers]
            if len(srcs) == 1:
                cur, ms = srcs[0], 0.0
            else:
                fn = jax.jit(lambda *ts: jnp.concatenate(ts, axis=-1))
                cur, ms = timed(fn, *srcs)
        elif isinstance(l, RegionSpec):
            if plan is not None:
                cur = convops.dequantize_int16(cur, plan.output_q)
            ms = 0.0
        acts[l.idx] = cur
        eb = {"int16": 2, "int8": 1}.get(precision, 4)
        ops, byt = layer_ops_bytes(l, batch, eb)
        t = LayerTiming(l.idx, l.type, ms, detail,
                        tops=ops / ms / 1e9 if ms > 0 else 0.0,
                        gbs=byt / ms / 1e6 if ms > 0 else 0.0)
        report.timings.append(t)
        if progress:
            print(f"  layer {l.idx:2d} {l.type:14s} {ms:8.3f} ms "
                  f"{t.tops:6.1f} TOPS {t.gbs:6.0f} GB/s  {detail}",
                  flush=True)
    report.total_ms = sum(t.ms for t in report.timings)
    return report


def prefix_alive_sets(spec: NetworkSpec) -> dict[int, set[int]]:
    """The layers XLA actually keeps in the prefix program ending at each
    layer (its ancestors, following the sequential chain except routes,
    which pull their listed absolute sources)."""
    alive: dict[int, set[int]] = {}
    for l in spec.layers:
        if isinstance(l, RouteSpec):
            s = {l.idx}
            for src in l.layers:
                s |= alive[src]
        elif l.idx == 0:
            s = {0}
        else:
            s = {l.idx} | alive[l.idx - 1]
        alive[l.idx] = s
    return alive


def attribute_prefix_delta(alive: dict[int, set[int]],
                           cums: dict[int, float],
                           deltas: dict[int, float],
                           idx: int, cur: float) -> float:
    """One layer's cost from prefix cums, DCE-aware.

    A prefix ending inside one branch of a route dead-code-eliminates the
    other branch (yolov2's 13^2 tower disappears from the route-25
    prefix), so the naive cum(n)-cum(n-1) delta would zero the route row
    and re-bill the whole eliminated branch to the rejoining route
    (observed: +24 ms on route 28, total 118 vs the real 91 ms). The
    delta is therefore taken against the best previously timed prefix
    whose alive set is a SUBSET of this one, minus already-attributed
    deltas of the other layers new to this prefix."""
    base = None
    for mi, mc in cums.items():
        if alive[mi] <= alive[idx] and (base is None or mc > cums[base]):
            base = mi
    new = alive[idx] - (alive[base] if base is not None else set()) - {idx}
    already = sum(deltas.get(k, 0.0) for k in new)
    return max(0.0, cur - (cums[base] if base is not None else 0.0)
               - already)


def profile_prefix(spec: NetworkSpec, store, precision: str = "int16",
                   compute: str = "int32", batch: int = 8,
                   chain: int = 8, rng_seed: int = 0,
                   progress: bool = False) -> ProfileReport:
    """IN-PROGRAM per-layer cost via prefix bisection (production mix).

    ``profile_layers`` times each layer as an isolated jitted segment,
    which misses how XLA fuses neighbouring layers in the whole program.
    Here layer i's cost is time(prefix i+1) - time(prefix i), each prefix
    being the REAL ``build_forward`` program truncated after layer i — the
    analog of the reference's built-in per-layer µs report
    (yolo2_inference.c:75-142).

    Compiles one program per layer; with the persistent compile cache
    warm this is minutes, cold it can be much longer.
    """
    import jax
    import jax.numpy as jnp

    from ..models import yolov2 as m

    rng = np.random.default_rng(rng_seed)
    report = ProfileReport()

    x = jnp.asarray(rng.random(
        (batch, spec.net.height, spec.net.width, spec.net.channels),
        dtype=np.float32))
    xs = [x + jnp.float32(i) * jnp.float32(1e-6) for i in range(chain)]

    def _time_prefix(n: int) -> float:
        pspec = NetworkSpec(net=spec.net, layers=spec.layers[:n])
        if precision == "int16":
            params = m.params_int16(pspec, store)
            fwd = m.build_forward(pspec, "int16", store.qtables,
                                  compute=compute, outputs=("head",))
        elif precision == "int8":
            params = m.params_int8(pspec, store)
            fwd = m.build_forward(pspec, "int8", store.qtables8,
                                  compute=compute, outputs=("head",))
        else:
            params = m.params_fp32(pspec, store)
            fwd = m.build_forward(pspec, "fp32", outputs=("head",))
        fn = jax.jit(lambda v: fwd(params, v)["head"])

        def run_all():
            return jax.block_until_ready([fn(xi) for xi in xs])

        run_all()                                        # compile + warm
        ts = []
        for _i in range(3):
            t0 = time.perf_counter()
            run_all()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3 / chain

    alive = prefix_alive_sets(spec)
    cums: dict[int, float] = {}
    deltas: dict[int, float] = {}
    for n, l in enumerate(spec.layers, start=1):
        cur = _time_prefix(n)
        ms = attribute_prefix_delta(alive, cums, deltas, l.idx, cur)
        cums[l.idx] = cur
        deltas[l.idx] = ms
        detail = ""
        if isinstance(l, ConvSpec):
            detail = f"{l.size}x{l.size}/{l.stride} {l.c}->{l.n}"
        eb = {"int16": 2, "int8": 1}.get(precision, 4)
        ops, byt = layer_ops_bytes(l, batch, eb)
        t = LayerTiming(l.idx, l.type, ms, detail,
                        tops=ops / ms / 1e9 if ms > 0 else 0.0,
                        gbs=byt / ms / 1e6 if ms > 0 else 0.0)
        report.timings.append(t)
        if progress:
            print(f"  prefix {n:2d} {l.type:14s} cum {cur:8.3f} ms  "
                  f"+{ms:7.3f}  {t.tops:6.1f} TOPS  {detail}", flush=True)
    # the full program's cum is the honest end-to-end device time
    report.total_ms = cums[spec.layers[-1].idx]
    return report


class StepTimer:
    """End-to-end step latency collector -> p50/p90/mean/fps (the metrics
    the reference's report tool extracts from 'inference time:' log lines,
    scripts/YOLO2_REPORT_TOOL.md:177-184)."""

    def __init__(self):
        self.samples_ms: list[float] = []

    def add(self, ms: float) -> None:
        self.samples_ms.append(ms)

    def summary(self, frames_per_step: int = 1) -> dict:
        a = np.asarray(self.samples_ms)
        if a.size == 0:
            return {"count": 0}
        return {
            "count": int(a.size),
            "mean_ms": float(a.mean()),
            "median_ms": float(np.median(a)),
            "p90_ms": float(np.percentile(a, 90)),
            "fps": float(frames_per_step * 1000.0 / np.median(a)),
        }
