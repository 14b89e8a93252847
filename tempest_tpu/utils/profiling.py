"""Observability: first-class throughput metrics and device profiling.

The reference's observability is ad-hoc: wall-clock ``Rate`` meters printed
at exit (``AtomicAbstractSDRs.jl:199-268,333-341``) and FPS ``@info`` lines
(``GUI.jl:201-203``).  Here metrics are a structured API (the ring's
``RateMeter`` feeds this registry) and device-side profiling delegates to
``jax.profiler`` traces viewable in XProf/TensorBoard (SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import time

__all__ = ["Metrics", "trace", "annotate", "stage_times", "profile_stages",
           "PER_KERNEL_OPTIONS"]


class Metrics:
    """Lightweight metric registry: counters + gauges + derived rates."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}

    def count(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def rate(self, name: str) -> float:
        """Counter per second since creation."""
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return self.counters.get(name, 0.0) / dt

    def snapshot(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "uptime_s": dt,
            "counters": dict(self.counters),
            "rates_per_s": {k: v / dt for k, v in self.counters.items()},
            "gauges": dict(self.gauges),
        }

    def json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``jax.profiler`` device trace for the enclosed block:

    >>> with trace("/tmp/tt_trace"):
    ...     step(iq, ema, alpha)

    View with TensorBoard/XProf pointed at ``log_dir``."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside a trace (``jax.profiler.TraceAnnotation``)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


_HLO_OP_NAME = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?\bmetadata=\{[^}]*?op_name="([^"]*)"',
    re.M)


def _unwrap(component: str) -> str:
    """``vmap(sync)`` → ``sync``: transformations wrap a scope's name."""
    while (m := re.fullmatch(r"[a-z_]+\((.*)\)", component)):
        component = m.group(1)
    return component


def _hlo_op_names(hlo_text: str) -> dict[str, str]:
    """Instruction name → ``op_name`` metadata (the ``jax.named_scope`` path)
    of every instruction in a compiled module's text
    (``jitted.lower(...).compile().as_text()``)."""
    return {m.group(1): m.group(2) for m in _HLO_OP_NAME.finditer(hlo_text)}


def stage_times(trace_dir: str, hlo_text: str, stages: tuple[str, ...],
                module: str | None = None) -> dict[str, float]:
    """Device seconds per named stage of one traced program.

    Reads the newest ``*.xplane.pb`` under ``trace_dir`` (written by
    :func:`trace`), takes every op event that carries an ``hlo_op`` stat —
    on the device planes (``/device:...``) when the trace has any, else on
    the host plane (the CPU backend runs ops there) — restricted to
    ``module`` (a substring of its ``hlo_module`` stat) when given, and
    charges each event's duration to the innermost of ``stages`` in the
    ``op_name`` path of its ``hlo_op`` instruction in ``hlo_text``.  Time
    in no stage is ``"other"``; ``"total"`` sums them all and ``"events"``
    counts them.  On the GPU, trace a program compiled with
    :data:`PER_KERNEL_OPTIONS` (see :func:`profile_stages`): inside a
    command buffer every kernel's ``hlo_op`` is "command_buffer".
    """
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb trace under {trace_dir}")
    names = _hlo_op_names(hlo_text)
    events = []
    for plane in ProfileData.from_file(paths[-1]).planes:
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                op = st.get("hlo_op")
                if op is None:
                    continue
                if module is not None and module not in str(st.get("hlo_module", "")):
                    continue
                events.append((plane.name.startswith("/device:"), str(op),
                               ev.duration_ns))
    on_device = any(dev for dev, _, _ in events)
    out = {s: 0.0 for s in (*stages, "other")}
    n = 0
    for dev, op, dur_ns in events:
        if dev != on_device:
            continue
        path = [_unwrap(c) for c in names.get(op, "").split("/")]
        hit = [s for s in path if s in stages]
        out[hit[-1] if hit else "other"] += dur_ns * 1e-9
        n += 1
    out["total"] = sum(out[s] for s in (*stages, "other"))
    out["events"] = n
    return out


# XLA's GPU backend launches a module's kernels as CUDA graphs (command
# buffers), whose trace events all carry the hlo_op "command_buffer".
# Compiled with command buffers off, every kernel — library GEMMs included —
# carries its own instruction.  Other backends ignore the option.
PER_KERNEL_OPTIONS = {"xla_gpu_enable_command_buffer": ""}


def profile_stages(lowered, args: tuple, trace_dir: str,
                   stages: tuple[str, ...], module: str | None = None
                   ) -> dict[str, float]:
    """:func:`stage_times` of one call of ``lowered`` (a
    ``jax.stages.Lowered``) on ``args``, compiled with
    :data:`PER_KERNEL_OPTIONS`: one untraced call warms it, the next is
    traced into ``trace_dir``.  Kernel times are those of the program as
    compiled for serving; launch gaps may differ."""
    import jax

    exe = lowered.compile(compiler_options=PER_KERNEL_OPTIONS)
    jax.block_until_ready(exe(*args))
    with trace(trace_dir):
        jax.block_until_ready(exe(*args))
    return stage_times(trace_dir, exe.as_text(), stages, module)
