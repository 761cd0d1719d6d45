"""Importance-sampling core of the port."""
