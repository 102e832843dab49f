"""Data of the port (counterpart of ``rocket_tpu.data``): text, array
datasets and on-device image augmentation."""
