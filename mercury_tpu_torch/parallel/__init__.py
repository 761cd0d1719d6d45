"""Data parallelism of the port: collectives over ``torch.distributed``
(:mod:`.collectives`) and the launch of one process a rank
(:mod:`.distributed`)."""
