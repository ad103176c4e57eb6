"""Impact engine (port of ``repro.kernels``): plain PyTorch forms in
``ref.py``/``fused_round.py``, hand-written CUDA kernels under ``csrc/``
bound through ``_build.py``, and the backend dispatch in ``ops.py``.
Importing this package builds and loads nothing."""
