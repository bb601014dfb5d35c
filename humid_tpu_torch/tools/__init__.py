"""Measurement scripts of the port (run with ``python -m``)."""
