"""Data ingest, partitioning and the on-device pipeline of the port."""
