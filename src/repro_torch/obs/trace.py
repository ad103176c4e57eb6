"""Span tracing, structured JSONL events, and the ``profile()`` bracket.

Spans are lightweight context managers recording wall-clock duration
into the registry (``span.<name>.seconds`` histogram plus a
``span.<name>.calls`` counter) and, when an event sink is attached,
emitting one structured event per span with nesting depth, parent span
name, and per-span attrs.  When the registry is disabled,
``span(...)`` returns a shared no-op object — no allocation, no timer.

Event sinks are callables taking one dict; ``jsonl_sink(path)`` adapts
a file path.  Setting ``CAMEO_OBS_EVENTS=<path>`` in the environment
attaches a JSONL file sink to the process-wide registry at import.

``profile(logdir)`` is the opt-in ``torch.profiler`` bracket for card/CPU
trace capture; it imports torch lazily so the obs package itself stays
dependency-free.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

_TLS = threading.local()


def _stack():
    s = getattr(_TLS, "spans", None)
    if s is None:
        s = _TLS.spans = []
    return s


class _NullSpan:
    """Shared no-op span returned when the registry is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        return self


NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("name", "attrs", "registry", "t0", "depth", "parent")

    def __init__(self, registry, name, attrs):
        self.registry = registry
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.depth = 0
        self.parent = None

    def set(self, key, value):
        """Attach/overwrite an attr mid-span."""
        self.attrs[key] = value
        return self

    def __enter__(self):
        stack = _stack()
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        reg = self.registry
        reg.observe(f"span.{self.name}.seconds", dt)
        reg.inc(f"span.{self.name}.calls")
        if reg._sinks:
            ev = {"ev": "span", "name": self.name, "dur_s": dt,
                  "depth": self.depth, "parent": self.parent}
            if exc_type is not None:
                ev["error"] = exc_type.__name__
            if self.attrs:
                ev["attrs"] = self.attrs
            emit_event(reg, ev)
        return False


def current_span():
    """The innermost active span on this thread, or None."""
    s = _stack()
    return s[-1] if s else None


def jsonl_sink(path):
    """An event sink appending one JSON object per line to ``path``."""
    lock = threading.Lock()

    def sink(ev):
        line = json.dumps(ev, sort_keys=True, default=str)
        with lock:
            with open(path, "a") as f:
                f.write(line + "\n")

    sink.path = path
    return sink


def emit_event(registry, ev):
    """Deliver one structured event dict to every attached sink."""
    if "ts" not in ev:
        ev = dict(ev, ts=time.time())
    for sink in registry._sinks:
        try:
            sink(ev)
        except Exception:
            pass  # telemetry must never take down the data path


def attach_env_sink(registry):
    """Honor ``CAMEO_OBS_EVENTS=<path>`` by attaching a JSONL sink."""
    path = os.environ.get("CAMEO_OBS_EVENTS", "").strip()
    if path:
        registry._sinks.append(jsonl_sink(path))


@contextlib.contextmanager
def profile(logdir=None):
    """Opt-in ``torch.profiler`` bracket: traces device + host activity
    for the wrapped region into ``logdir`` (a Chrome trace, viewable with
    TensorBoard or Perfetto).  Usable regardless of the ``CAMEO_OBS``
    flag — the explicit call *is* the opt-in.  Never raises: if the
    profiler is unavailable or already active the region simply runs
    untraced.
    """
    import tempfile

    if logdir is None:
        logdir = os.environ.get("CAMEO_OBS_PROFILE_DIR") or os.path.join(
            tempfile.gettempdir(), "cameo_profile")
    prof = None
    try:
        import torch
        from torch import profiler as tp

        if torch.autograd._profiler_enabled():
            # a profiler is already on: starting a second one would end
            # the first at its stop (and crash the first's own stop)
            raise RuntimeError("profiler already active")
        acts = [tp.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
        prof = tp.profile(activities=acts,
                          on_trace_ready=tp.tensorboard_trace_handler(logdir))
        prof.start()
    except Exception:
        prof = None
    try:
        yield logdir
    finally:
        if prof is not None:
            try:
                prof.stop()
            except Exception:
                pass
