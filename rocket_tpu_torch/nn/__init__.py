"""Layers of the decode path (counterpart of ``rocket_tpu.nn``)."""
