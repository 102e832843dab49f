"""Models of the port (counterpart of ``rocket_tpu.models``)."""
