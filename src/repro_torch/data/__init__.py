"""Seeded synthetic datasets and the training data pipeline (port of
``repro.data``)."""
