"""Utilities of the port (counterpart of ``rocket_tpu.utils``)."""
