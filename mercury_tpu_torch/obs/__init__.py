"""Sampler-health telemetry of the port: the step's in-graph scalars and
histograms (:mod:`.diagnostics`, the torch half of :mod:`.sampler_health`)
and the host-side ledger monitor (the numpy half of :mod:`.sampler_health`).
The PyTorch counterpart of ``mercury_tpu/obs/diagnostics.py`` and
``mercury_tpu/obs/sampler_health.py``."""
