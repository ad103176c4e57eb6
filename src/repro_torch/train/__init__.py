"""Training (port of ``repro.train``): the train ``step``, the
fault-tolerant ``loop`` and the explicit data-parallel step
``dp_shardmap``."""
