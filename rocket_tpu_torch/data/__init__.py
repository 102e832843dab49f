"""Text data of the port (counterpart of ``rocket_tpu.data``)."""
