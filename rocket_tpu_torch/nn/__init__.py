"""Layers of the port (counterpart of ``rocket_tpu.nn``)."""
