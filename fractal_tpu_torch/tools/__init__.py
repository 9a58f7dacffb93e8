"""Probe and measurement entry points of the port (counterparts of ``tools/``)."""
