"""Optimizers (port of ``repro.optim``): ``adamw``, ``adafactor``, the
learning-rate ``schedule``s and the gradient codecs of ``compress``."""
