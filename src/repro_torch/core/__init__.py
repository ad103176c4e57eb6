"""CAMEO compressor and series math (port of ``repro.core``)."""
