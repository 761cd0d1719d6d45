"""Observability of the port: the step's sampler-health scalars and
histograms (:mod:`.diagnostics`, the torch half of :mod:`.sampler_health`),
the host-side ledger monitor (the numpy half of :mod:`.sampler_health`),
the async metric writer and its sinks (:mod:`.writer`), throughput, FLOPs
and MFU (:mod:`.accounting`), the run manifest (:mod:`.manifest`), the
event journal (:mod:`.events`) and the anomaly engine with its flight
recorder (:mod:`.anomaly`). The PyTorch counterpart of the same modules
of ``mercury_tpu/obs/``."""
