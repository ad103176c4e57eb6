"""Serving front ends (port of ``repro.serving``): the deprecated
``ts_service`` shim over the ingest server."""
