"""PyTorch/CUDA port of the CAMEO compressor (the JAX package ``repro`` is
the reference).

The port mirrors ``repro``'s module layout: ``core`` holds the compressor,
the series math and streaming ingest, ``kernels`` the impact engine with
one hand-written CUDA kernel per ported TPU kernel beside its plain
PyTorch version, ``store`` the block store and ``obs`` the telemetry
registry.
Importing the package does no CUDA work and builds nothing; kernels are
compiled on their first launch (``kernels/_build.py``).
"""
