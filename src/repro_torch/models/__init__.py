"""The model substrate (port of ``repro.models``), the attention path:
``params`` (definition trees, init), ``layers``, ``attention`` and
``model`` (forward, prefill, decode)."""
