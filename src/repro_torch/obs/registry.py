"""Process-wide metrics registry: counters, gauges, streaming histograms
(port of ``repro/obs/registry.py``: the same metric names, snapshot schema
and exposition text).

Zero-dependency by design (stdlib only — no numpy/torch import at module
level) so that ``repro_torch.obs`` can be threaded through every layer of the
stack without changing import graphs or adding overhead to processes
that never enable it.

Hot-path contract
-----------------
Instrumented call sites guard every observation with::

    if OBS.enabled:
        OBS.inc("stream.windows")

so the disabled path costs exactly one attribute lookup (verified by a
microbench in ``tests/test_obs.py``).  The registry itself never
allocates per-observation when disabled because the guard lives at the
call site, not inside the registry.

Histograms
----------
``StreamingHistogram`` is a bounded-memory log-bucketed sketch: buckets
are spaced ``2**(1/16)`` apart (16 sub-buckets per octave), giving a
worst-case relative quantile error of ~4.4% over the clamped range
``[2**-40, 2**40]`` (~9e-13 .. ~1.1e12) with at most 1280 occupied
buckets.  ``count``/``sum``/``min``/``max`` are exact.

Recompile watermark
-------------------
``register_jit(name, fn)`` records an entry point that compiles code; the
registry's ``recompile_watermark()`` sums ``fn._cache_size()`` over every
registered entry.  A before/after delta of the watermark around a
region counts the compilations triggered inside it.  Registration and
watermarking work regardless of the enabled flag: they are
introspection, not instrumentation.

This is the port's counterpart of the JAX package's no-recompile
watermark.  The port runs eagerly and has no jit: what it compiles are
its CUDA kernels, so ``kernels/_build.py`` registers its builder as
``kernels.build``, whose ``_cache_size()`` counts the libraries ``nvcc``
built in this process.  A zero delta across stream windows (a tail
window included) says no window built anything.  CUDA-graph captures
join the watermark when the port captures graphs (ROADMAP, "Carried
for the first benchmark PR").
"""
from __future__ import annotations

import math
import os
import threading

# Sub-buckets per octave (power of two).  16 -> ~4.4% relative error.
_SUB = 16
_LOG2_SUB = _SUB / math.log(2.0)  # multiply ln(v) by this to get bucket idx
_IDX_MIN = -40 * _SUB
_IDX_MAX = 40 * _SUB
_QUANTILES = (0.5, 0.95, 0.99)


def _fmt(v):
    """Deterministic number formatting for the exposition surface."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if v != v:  # NaN
        return "NaN"
    return format(v, ".10g")


def sanitize_metric_name(name):
    """Dotted metric name -> Prometheus-legal name (``a.b-c`` -> ``a_b_c``)."""
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() and ch.isascii()) or ch == "_" else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _escape_label(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def labeled(name, labels):
    """Render a metric name + label dict into the registry's labeled-key
    form, ``name{k="v",...}`` (keys sorted, values escaped).  Labeled
    series are just distinct keys in the counter/gauge/histogram dicts —
    the hot path stays a plain dict operation and the exposition surface
    recognises the embedded suffix (see ``exposition``).  An empty/None
    label dict returns the bare name, so unlabeled call sites are
    byte-for-byte unchanged."""
    if not labels:
        return name
    inner = ",".join(f'{sanitize_metric_name(str(k))}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def _split_key(name):
    """Split a (possibly labeled) metric key into ``(base, suffix)`` where
    ``suffix`` is the literal ``{...}`` label block or ``""``."""
    i = name.find("{")
    if i < 0:
        return name, ""
    return name[:i], name[i:]


def _expo_sorted(keys):
    """Exposition order: group by *sanitized* base name, then label
    block.  Sorting raw keys would let a dotted name (``a.b.c``) sort
    between a base (``a.b``) and its labeled ``a.b{...}`` keys and split
    the family across two ``# TYPE`` lines, which Prometheus parsers
    reject as a duplicate."""
    def order(name):
        base, suffix = _split_key(name)
        return sanitize_metric_name(base), suffix
    return sorted(keys, key=order)


class StreamingHistogram:
    """Bounded-memory streaming histogram with interpolated quantiles.

    Designed for non-negative measurements (latencies, byte counts,
    rounds).  Non-positive observations are counted and contribute to
    ``count``/``sum``/``min``/``max`` exactly; quantiles that land in the
    non-positive mass resolve to the tracked minimum.
    """

    __slots__ = ("count", "sum", "min", "max", "_nonpos", "_buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._nonpos = 0
        self._buckets = {}

    def observe(self, value):
        v = float(value)
        if v != v:  # drop NaN: it would poison sum/min/max
            return
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self._nonpos += 1
            return
        i = int(math.floor(math.log(v) * _LOG2_SUB))
        if i < _IDX_MIN:
            i = _IDX_MIN
        elif i > _IDX_MAX:
            i = _IDX_MAX
        b = self._buckets
        b[i] = b.get(i, 0) + 1

    def quantile(self, q):
        """Interpolated quantile; exact to within one bucket (~4.4% rel)."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        if target < 1.0:
            target = 1.0
        cum = self._nonpos
        if target <= cum:
            return self.min
        for i in sorted(self._buckets):
            c = self._buckets[i]
            if cum + c >= target:
                lo = 2.0 ** (i / _SUB)
                hi = 2.0 ** ((i + 1) / _SUB)
                frac = (target - cum) / c
                v = lo * (hi / lo) ** frac
                return min(max(v, self.min), self.max)
            cum += c
        return self.max

    def snapshot(self):
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": math.nan, "max": math.nan,
                    "p50": math.nan, "p95": math.nan, "p99": math.nan}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.5),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


def _env_enabled():
    return os.environ.get("CAMEO_OBS", "0").strip().lower() not in (
        "", "0", "false", "off", "no")


class MetricsRegistry:
    """Counters, gauges, histograms, span stats, and the build watermark.

    One process-wide instance (``repro_torch.obs.OBS``) is created at import;
    independent instances can be built for tests.  Mutating calls are
    cheap dict operations (no locking on the hot path — CPython's GIL
    makes the worst race a lost increment, acceptable for telemetry);
    a lock guards structural operations (histogram creation, sinks).
    """

    def __init__(self, enabled=None):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self._counters = {}
        self._gauges = {}
        self._hists = {}
        self._jits = {}
        self._sinks = []
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------
    def inc(self, name, delta=1, labels=None):
        if labels:
            name = labeled(name, labels)
        c = self._counters
        c[name] = c.get(name, 0) + delta

    def gauge(self, name, value, labels=None):
        if labels:
            name = labeled(name, labels)
        self._gauges[name] = value

    def observe(self, name, value, labels=None):
        if labels:
            name = labeled(name, labels)
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, StreamingHistogram())
        h.observe(value)

    def counter_value(self, name, default=0):
        return self._counters.get(name, default)

    def histogram(self, name):
        return self._hists.get(name)

    # -- enable / disable --------------------------------------------------
    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def reset(self):
        """Clear recorded metrics.  Jit registrations and sinks survive:
        they describe process structure, not accumulated measurements."""
        self._counters.clear()
        self._gauges.clear()
        with self._lock:
            self._hists.clear()

    # -- build watermark ---------------------------------------------------
    def register_jit(self, name, fn):
        """Register an entry point for the recompile watermark.

        ``fn`` is any object with a ``_cache_size()`` (the count of what
        it compiled so far).  Re-registering a name replaces the previous
        object.
        """
        if not hasattr(fn, "_cache_size"):
            raise TypeError(
                f"register_jit({name!r}): object has no _cache_size(); "
                "pass the compiling object itself")
        self._jits[name] = fn

    def recompile_counts(self):
        """Per-entry compiled-variant counts, ``{name: cache_size}``."""
        return {name: int(fn._cache_size()) for name, fn in
                sorted(self._jits.items())}

    def recompile_watermark(self):
        """Total compiled variants across every registered entry.

        Take a delta of this around any region to count recompiles
        triggered inside it (0 delta == the no-recompile property the
        perf gates assert).
        """
        return sum(int(fn._cache_size()) for fn in self._jits.values())

    # -- export surfaces ---------------------------------------------------
    def snapshot(self):
        """The documented snapshot schema (stable keys, plain types)::

            {
              "enabled":    bool,
              "counters":   {name: int},
              "gauges":     {name: number},
              "histograms": {name: {count,sum,min,max,p50,p95,p99}},
              "recompiles": {"total": int, "entries": {name: int}},
            }
        """
        return {
            "enabled": self.enabled,
            "counters": dict(sorted(self._counters.items())),
            "gauges": dict(sorted(self._gauges.items())),
            "histograms": {k: self._hists[k].snapshot()
                           for k in sorted(self._hists)},
            "recompiles": {
                "total": self.recompile_watermark(),
                "entries": self.recompile_counts(),
            },
        }

    def exposition(self, prefix="cameo"):
        """Prometheus-style text exposition of the current registry.

        Counters become ``<prefix>_<name>_total``, gauges bare samples,
        histograms summaries with ``quantile`` labels plus ``_sum`` /
        ``_count``.  Dots in metric names map to underscores.  Labeled
        series (keys of the ``name{k="v"}`` form written by the
        ``labels=`` kwarg) render their label block after the sample
        name, share one ``# TYPE`` line with their base metric, and for
        histograms merge the ``quantile`` label into the block.  Output
        is deterministic (sorted) so it can be golden-tested.
        """
        lines = []
        last = None
        for name in _expo_sorted(self._counters):
            base, suffix = _split_key(name)
            m = f"{prefix}_{sanitize_metric_name(base)}"
            if m != last:
                lines.append(f"# TYPE {m} counter")
                last = m
            lines.append(f"{m}_total{suffix} {_fmt(self._counters[name])}")
        last = None
        for name in _expo_sorted(self._gauges):
            base, suffix = _split_key(name)
            m = f"{prefix}_{sanitize_metric_name(base)}"
            if m != last:
                lines.append(f"# TYPE {m} gauge")
                last = m
            lines.append(f"{m}{suffix} {_fmt(self._gauges[name])}")
        last = None
        for name in _expo_sorted(self._hists):
            h = self._hists[name]
            base, suffix = _split_key(name)
            m = f"{prefix}_{sanitize_metric_name(base)}"
            if m != last:
                lines.append(f"# TYPE {m} summary")
                last = m
            for q in _QUANTILES:
                qlab = (f'{{{suffix[1:-1]},quantile="{_fmt(q)}"}}' if suffix
                        else f'{{quantile="{_fmt(q)}"}}')
                lines.append(f"{m}{qlab} {_fmt(h.quantile(q))}")
            lines.append(f"{m}_sum{suffix} {_fmt(h.sum)}")
            lines.append(f"{m}_count{suffix} {_fmt(h.count)}")
        if self._jits:
            m = f"{prefix}_recompile_watermark"
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(self.recompile_watermark())}")
        return "\n".join(lines) + "\n"
