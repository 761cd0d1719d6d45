"""Tensor helpers of the port."""
