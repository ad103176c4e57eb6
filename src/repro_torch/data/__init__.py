"""Seeded synthetic datasets (port of ``repro.data``)."""
