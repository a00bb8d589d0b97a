"""Training checkpoint and resume (port of ``flowgen/train/checkpoints.py``).

The data stream is a pure function of ``(seed, step)``, so checkpointing the
whole pipeline is the model's and the optimizer's state plus the step
counter. A checkpoint is one ``torch.save`` file, ``<path>/step_%08d``,
holding ``{"step", "model", "optimizer"}`` (the two ``state_dict``\\ s)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def _file(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def save_checkpoint(path: str, step: int, model, opt) -> None:
    os.makedirs(path, exist_ok=True)
    torch.save({"step": int(step), "model": model.state_dict(),
                "optimizer": opt.state_dict()}, _file(path, step))


def restore_checkpoint(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """Load the latest (or a given) checkpoint onto the CPU: ``{"step",
    "model", "optimizer"}``, for ``model.load_state_dict`` and
    ``opt.load_state_dict``. The returned ``step`` both resumes the
    optimizer schedule and seeks the data stream
    (``Generator(start_step=...)`` / ``generate_batch(step=...)``)."""
    if step is None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(path) if d.startswith("step_")
        )
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    return torch.load(_file(path, step), map_location="cpu", weights_only=True)
