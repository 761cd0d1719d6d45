"""Train state, step and trainer of the port."""
