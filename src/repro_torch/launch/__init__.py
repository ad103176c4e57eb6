"""Launchers and the production-mesh layer (port of ``repro.launch``):
``serve``, ``train``, ``mesh``, ``specs``, ``analytic``, ``dryrun`` and
``collectives`` (the counterpart of ``hlo``)."""
