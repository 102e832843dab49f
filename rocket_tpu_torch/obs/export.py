"""Process identity for the ops plane's records (counterpart of
``host_identity`` of ``rocket_tpu/obs/export.py``).

The rest of the reference's module — the streaming metric shards, the
Prometheus ``/metrics`` endpoint and their configuration — is the live
export plane, not ported yet (ROADMAP Queue A 7b); ``Runtime(export=...)``
and ``Telemetry.start_export`` raise until it is.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

__all__ = ["host_identity"]


def host_identity(process_index: Optional[int] = None) -> dict:
    """``{"rank", "hostname", "pid"}`` of this process, for stall reports
    and black-box manifests. The rank is ``process_index`` when the caller
    knows it, else the launcher's ``RANK`` (torch.distributed's variable;
    the reference reads ``JAX_PROCESS_ID``), else 0."""
    if process_index is None:
        raw = os.environ.get("RANK", "").strip()
        process_index = int(raw) if raw.isdigit() else 0
    try:
        hostname = socket.gethostname()
    except OSError:
        hostname = "unknown"
    return {"rank": int(process_index), "hostname": hostname, "pid": os.getpid()}
