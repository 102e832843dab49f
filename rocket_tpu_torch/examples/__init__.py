"""The port's counterparts of ``examples/``: ``char_lm`` (train and
checkpoint the char-transformer) and ``generate`` (sample from its newest
checkpoint). Run them as ``python -m rocket_tpu_torch.examples.<name>``."""
