"""rocket_tpu_torch.tune — generate-and-verify kernel tuning (counterpart
of ``rocket_tpu/tune``).

* :mod:`~rocket_tpu_torch.tune.space`: the legal config set of each
  tunable kernel (:class:`TuneSpace`), launch-config axes and structural
  ones (the CUDA kernel or the plain path, fusion boundaries, schedules);
* :mod:`~rocket_tpu_torch.tune.table`: the JSON tables under
  ``rocket_tpu_torch/tune/configs/``, keyed (device name, shape bucket,
  dtype) with longest-prefix device matching, and :func:`get_config`, the
  lookup the call sites read; an empty table runs the defaults;
* :mod:`~rocket_tpu_torch.tune.tuner` and ``python -m
  rocket_tpu_torch.tune``: the sweep on the card, build excluded from the
  timing, every candidate held to the default's forward outputs and
  gradients before it is timed, winners written with ``--update-table``.
"""

from rocket_tpu_torch.tune.space import TUNE_SPACES, TuneSpace, canonical_dtype
from rocket_tpu_torch.tune.table import (
    CONFIGS_DIR,
    device_kind,
    get_config,
    load_table,
    load_tables,
    lookup_log,
    lookup_log_summary,
    priced_device_kind,
    reset_lookup_log,
    reset_table_cache,
    tables_summary,
    tuning_disabled,
    validate_tables,
    write_table,
)

__all__ = [
    "TUNE_SPACES", "TuneSpace", "canonical_dtype", "CONFIGS_DIR", "device_kind", "get_config",
    "load_table", "load_tables", "lookup_log", "lookup_log_summary", "priced_device_kind",
    "reset_lookup_log", "reset_table_cache", "tables_summary", "tuning_disabled",
    "validate_tables", "write_table",
]
