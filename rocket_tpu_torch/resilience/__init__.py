"""Resilience (counterpart of ``rocket_tpu.resilience``): so far only the
checkpoint-completeness scan that resume and the supervisor share."""
