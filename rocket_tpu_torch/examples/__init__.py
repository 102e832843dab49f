"""The port's counterparts of ``examples/``: ``char_lm`` (train and
checkpoint the char-transformer), ``generate`` (sample from its newest
checkpoint), ``cifar_resnet`` (ResNet-18 on CIFAR-10), ``vit_cifar`` (ViT-Ti
on CIFAR-10), ``mnist`` (LeNet), ``llama_lm`` (the Llama-family char-LM),
``gpt2`` (GPT-2 124M pretraining) and ``moe_lm`` (the Mixture-of-Experts
char-LM). Run them as ``python -m rocket_tpu_torch.examples.<name>``."""
