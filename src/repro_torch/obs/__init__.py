"""``repro_torch.obs`` — the unified telemetry layer for the CAMEO stack
(port of ``repro/obs``: the same metric names, snapshot schema and
exposition text; ``profile`` brackets ``torch.profiler``).

One process-wide :class:`~repro_torch.obs.registry.MetricsRegistry` (``OBS``)
collects counters, gauges, and bounded-memory streaming histograms from
every layer — streaming ingest (``stream.*``), the elimination kernels
(``mvar.*``, ``write.*``), the block store (``store.*``), the pushdown
query planner (``query.*``), and span timings (``span.*``) — and
exports them as a plain dict (:func:`snapshot`) or Prometheus-style
text (:func:`exposition`).

Enabling
--------
Telemetry is **off by default**.  Set ``CAMEO_OBS=1`` in the
environment or call :func:`enable` at runtime.  Every instrumented hot
path is guarded by ``if OBS.enabled:`` so the disabled cost is a single
attribute lookup (bounded by a microbench in ``tests/test_obs.py``),
and enabling telemetry changes **no** compressed bytes and **no** query
answers (differential-tested).  Steady-state ingest overhead with
telemetry on is gated at <= 3% in ``benchmarks/perf_smoke.py``
(``obs_overhead`` row).

Metric name inventory (the production names; benchmarks reuse them)
-------------------------------------------------------------------
================================  =====================================
``stream.push_seconds``            per-push latency histogram
``stream.windows`` / ``stream.windows_verbatim``  windows closed / kept-verbatim
``stream.window_rounds``           elimination rounds per window (hist)
``stream.window_eps_headroom``     measured deviation / eps budget (hist)
``stream.pad_to_bucket_hits``      partial tails padded to the full bucket
``stream.queue_depth`` (gauge) / ``stream.queue_drains`` / ``stream.drain_windows``
``mvar.repair_halvings``           per-column eps repair loop halvings
``write.seconds`` / ``write.eps_headroom``  one-shot facade writes
``store.cache.hits|misses|evictions``  decoded-block LRU traffic
``store.read.mmap_bytes|pread_bytes``  body bytes by read path
``store.read.coalesced_runs|blocks_fetched``  pread coalescing
``store.write.blocks|bytes``       block bodies appended
``wal.records`` / ``wal.append_bytes``  write-ahead journal appends
``wal.group_commits`` / ``wal.group_batch_records``  fsync barriers / batch size (hist)
``wal.fsync_seconds``              group-commit fsync latency (hist)
``wal.checkpoints`` / ``wal.recoveries``  journal truncations / crash recoveries
``wal.replayed_records|points``    journaled pushes re-fed on resume
``ingest.ack_seconds``             façade push journal-ack latency (hist)
``query.count`` / ``query.kind.<agg>`` / ``query.seconds``  query dispatch
``query.segments_meta|segments_edge``  pushdown-vs-decode block decisions
``query.meta_only|with_edge_decode``   per-query decision outcome
``query.bound_width``              realized pushdown bound widths (hist)
``span.<name>.seconds|calls``      user/code spans
``server.sessions`` (gauge) / ``server.pushes|points|rejects``  ingest server
``server.tenant.pushes|points``    per-tenant (labeled ``{tenant="..."}``)
``store.tier.cold.hits|bytes``     cold-tier (entropy-wrapped) body fetches
``store.compaction.runs|blocks_merged|dead_bytes``  compaction rewrites
================================  =====================================

Labels
------
``inc``/``gauge``/``observe`` take an optional ``labels`` dict; a
labeled series is stored under the rendered key ``name{k="v"}`` (sorted
keys), shares its base metric's ``# TYPE`` line in :func:`exposition`,
and costs nothing when ``labels`` is ``None`` — the disabled-path
contract (one attribute lookup behind ``if OBS.enabled:``) is
unchanged.  The ingest server labels its per-tenant traffic this way;
unlabeled call sites produce byte-identical exposition to before.

The unified stats snapshot schema
---------------------------------
The historical per-layer ``stats()`` dicts now share one schema for
overlapping concepts.  ``Dataset.stats()`` and
``TimeSeriesService.stats()`` both return::

    series, points, n_kept, stored_nbytes, raw_nbytes,
    point_cr, bytes_cr, cache={hits,misses,evictions,entries,nbytes,budget}

computed from O(1) running ingest totals (``CameoStore.ingest_totals``)
— pass ``deep=True`` for the exhaustive per-series ``compression_stats``
walk (adds ``per_series``).  The same cache counters also stream into
the registry as ``store.cache.*``.  :func:`snapshot` is the documented
registry schema (see :meth:`MetricsRegistry.snapshot`).

Recompiles
----------
:func:`register_jit` + :func:`recompile_watermark` count what the
process compiled.  The port has no jit: its one registered entry is the
CUDA kernel builder, ``kernels.build`` (``kernels/_build.py``), whose
count is the libraries ``nvcc`` built in this process, so a zero
watermark delta across a warmed region means nothing was built in it
(``core.streaming.compile_cache_size`` is a shim over it).
"""
from __future__ import annotations

from .registry import MetricsRegistry, StreamingHistogram, sanitize_metric_name
from .trace import (NULL_SPAN, Span, attach_env_sink, current_span,
                    emit_event, jsonl_sink, profile)

__all__ = [
    "OBS", "MetricsRegistry", "StreamingHistogram", "Span", "NULL_SPAN",
    "enable", "disable", "enabled", "reset", "inc", "gauge", "observe",
    "span", "event", "add_event_sink", "jsonl_sink", "current_span",
    "profile", "snapshot", "exposition", "register_jit",
    "recompile_watermark", "recompile_counts", "sanitize_metric_name",
]

#: The process-wide registry every instrumented layer records into.
OBS = MetricsRegistry()
attach_env_sink(OBS)


def enable():
    """Turn telemetry on for the process-wide registry."""
    OBS.enable()


def disable():
    """Turn telemetry off (instrumented sites fall back to one attribute
    lookup per potential observation)."""
    OBS.disable()


def enabled():
    return OBS.enabled


def reset():
    """Clear recorded metrics (registrations and sinks survive)."""
    OBS.reset()


def inc(name, delta=1, labels=None):
    OBS.inc(name, delta, labels=labels)


def gauge(name, value, labels=None):
    OBS.gauge(name, value, labels=labels)


def observe(name, value, labels=None):
    OBS.observe(name, value, labels=labels)


def span(name, **attrs):
    """``with obs.span("stream.push", sid=sid): ...`` — times the block
    into ``span.<name>.seconds``; nests; no-op when disabled."""
    if not OBS.enabled:
        return NULL_SPAN
    return Span(OBS, name, attrs)


def event(name, **fields):
    """Emit a structured event to the attached JSONL sinks."""
    if not OBS.enabled:
        return
    emit_event(OBS, dict(fields, ev=name))


def add_event_sink(sink):
    """Attach an event sink (a callable taking one dict, e.g.
    ``jsonl_sink(path)``)."""
    OBS._sinks.append(sink)


def snapshot():
    """The documented registry snapshot dict (see
    :meth:`MetricsRegistry.snapshot`)."""
    return OBS.snapshot()


def exposition(prefix="cameo"):
    """Prometheus-style text exposition of the process-wide registry."""
    return OBS.exposition(prefix)


def register_jit(name, fn):
    """Register a compiling entry point (any object with
    ``_cache_size()``) under the recompile watermark."""
    OBS.register_jit(name, fn)


def recompile_watermark():
    """Total compiled variants across all registered entries."""
    return OBS.recompile_watermark()


def recompile_counts():
    """Per-entry compiled-variant counts."""
    return OBS.recompile_counts()
