"""Observability of the port (counterpart of ``rocket_tpu.obs``): so far
the trace-window policy (``obs/prof.py``). The trace parser and the
telemetry registry wait for the ops plane (ROADMAP Queue A 7)."""
