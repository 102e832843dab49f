"""Data of the port (counterpart of ``rocket_tpu.data``): collate,
loader, prefetch, workers and the device-resident cache behind the
``Dataset`` capsule; text, array and MNIST datasets; on-device image
augmentation."""
