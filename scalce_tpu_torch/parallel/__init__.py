"""Data parallelism over the devices of one host (``mesh``)."""
