"""Training checkpoints: one ``torch.save`` file of
``{"model": state_dict, "optimizer": state, "step": int}``.

The model part is a plain ``state_dict``; :func:`load_model_state` gives it
back from such a file or from a file that holds a bare ``state_dict``, which
is what ``infer.load_model`` reads.  Resuming a run automatically is queued
in ROADMAP.md.
"""
from __future__ import annotations

import os
from typing import Dict

import torch


def save_checkpoint(path: str, model: torch.nn.Module, optimizer,
                    step: int) -> str:
    """Write the checkpoint atomically (a temporary file, then a rename);
    returns ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def load_model_state(path: str) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` from a checkpoint or a bare
    ``state_dict`` file."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state["model"] if "model" in state else state
