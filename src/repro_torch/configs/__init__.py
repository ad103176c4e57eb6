"""Model-zoo configurations (port of ``repro.configs``): the reference's
ten architecture files as data, the schema and the registry."""
