"""Observability of the port: the step's sampler-health scalars and
histograms (:mod:`.diagnostics`, the torch half of :mod:`.sampler_health`),
the host-side ledger monitor (the numpy half of :mod:`.sampler_health`),
the async metric writer and its sinks (:mod:`.writer`), throughput, FLOPs
and MFU (:mod:`.accounting`) and the run manifest (:mod:`.manifest`). The
PyTorch counterpart of the same modules of ``mercury_tpu/obs/``."""
