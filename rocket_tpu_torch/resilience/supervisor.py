"""The checkpoint-completeness scan of ``rocket_tpu/resilience/supervisor.py``
(:func:`is_complete_checkpoint`, :func:`newest_complete_step`), the one
definition of "restorable" that the Checkpointer's ``resume_from="latest"``
reads. The supervision loop itself waits for the ops plane (ROADMAP Queue A
7)."""

from __future__ import annotations

import json
import os
from typing import Optional

__all__ = ["is_complete_checkpoint", "newest_complete_step"]


def is_complete_checkpoint(candidate: str) -> bool:
    """A step directory is complete when its last artifact (``rng.json``)
    exists and every shard file that each ``model_*`` index names is on
    disk; a torn write fails one of the two."""
    if not os.path.exists(os.path.join(candidate, "rng.json")):
        return False
    try:
        entries = os.listdir(candidate)
    except OSError:
        return False
    for entry in entries:
        model_dir = os.path.join(candidate, entry)
        if not (entry.startswith("model_") and os.path.isdir(model_dir)):
            continue
        index_path = os.path.join(model_dir, "index.json")
        if not os.path.exists(index_path):
            return False
        try:
            with open(index_path, "r", encoding="utf-8") as f:
                index = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        files = {chunk["file"] for meta in index.values() if meta.get("kind") == "array"
                 for chunk in meta["chunks"]}
        if any(not os.path.exists(os.path.join(model_dir, name)) for name in files):
            return False
    return True


def newest_complete_step(output_dir: Optional[str]) -> Optional[int]:
    """The newest step directory under ``output_dir`` that passes
    :func:`is_complete_checkpoint`, or None."""
    if not output_dir or not os.path.isdir(output_dir):
        return None
    steps = sorted((int(d) for d in os.listdir(output_dir) if d.isdigit()), reverse=True)
    for step in steps:
        if is_complete_checkpoint(os.path.join(output_dir, str(step))):
            return step
    return None
