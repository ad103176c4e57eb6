"""Launchers (port of ``repro.launch``): ``serve``, ``train`` and
``specs.default_train_config``."""
