"""Host helpers of the port: tensor trees, quantizers, logging and meters."""
