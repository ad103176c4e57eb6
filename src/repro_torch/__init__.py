"""PyTorch/CUDA port of the CAMEO compressor (the JAX package ``repro`` is
the reference).

The port mirrors ``repro``'s module layout: ``api`` is the dataset façade
(``repro_torch.api.open(path, cfg)``), ``server`` the multi-tenant ingest
server and ``serving.ts_service`` its deprecated service shim; ``core``
holds the compressor, the series math and streaming ingest, ``kernels``
the impact engine with one hand-written CUDA kernel per ported TPU kernel
beside its plain PyTorch version, ``store`` the block store and ``obs``
the telemetry registry; ``configs``, ``models``, ``serving.engine``,
``serving.kv_prune`` and ``launch.serve`` serve the model zoo's attention
architectures, with CAMEO selecting what the KV cache keeps.
Importing the package does no CUDA work and builds nothing; kernels are
compiled on their first launch (``kernels/_build.py``).
"""
