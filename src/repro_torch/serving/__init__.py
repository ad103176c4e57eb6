"""Serving front ends (port of ``repro.serving``): the batched model
``engine``, CAMEO's KV-cache pruning ``kv_prune``, and the deprecated
``ts_service`` shim over the ingest server."""
