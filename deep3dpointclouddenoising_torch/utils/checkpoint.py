"""Training checkpoints: one ``torch.save`` file of
``{"model": state_dict, "optimizer": state, "step": int}``, and their
restore into a run.

Counterpart of ``deep3dpointclouddenoising_tpu/utils/checkpoint.py``.  The
model part is a plain ``state_dict`` (parameters and BatchNorm buffers);
the optimizer part is ``ChainedOptimizer.state_dict()``, the torch
optimizer's state (Adam's moments and step) and ``count``, the update count
the LR schedule reads.  :func:`load_model_state` gives the model part back
from such a file or from a file that holds a bare ``state_dict``, which is
what ``infer.load_model`` reads; :func:`load_checkpoint` restores a whole
train state into a ``Trainer`` and :func:`load_weights` its model only.
Files are written atomically (a temporary file, then a rename), so a run
killed while it saves leaves the previous checkpoint whole: the JAX
package's cleanup of orbax's temporary directories has nothing to do here.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

_EPOCH_FILE = re.compile(r"ckpt_epoch_(\d+)\.pt$")


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


def load_checkpoint(path: str, trainer) -> int:
    """Restore the whole train state of ``path`` into ``trainer``: the
    model's parameters and BatchNorm buffers, and the optimizer's state
    with ``count``, the step the LR schedule reads.  Returns the step."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "optimizer" not in state:
        raise ValueError(f"{path} holds model weights only, no train "
                         "state: warm-start from it with load_weights")
    trainer.model.load_state_dict(state["model"])
    trainer.optimizer.load_state_dict(state["optimizer"])
    if trainer.step != int(state["step"]):
        raise ValueError(f"{path}: the optimizer counted {trainer.step} "
                         f"updates, the checkpoint says {state['step']}")
    return trainer.step


def load_weights(path: str, trainer) -> None:
    """Restore the model weights of ``path`` (parameters and BatchNorm
    statistics) into ``trainer``, keeping its optimizer state and step: a
    warm start under a fresh optimizer and schedule (JAX's
    ``load_weights``)."""
    trainer.model.load_state_dict(load_model_state(path))


def latest_epoch_checkpoint(log_dir: str) -> Optional[str]:
    """The ``ckpt_epoch_<N>.pt`` of ``log_dir`` with the largest N, else its
    ``current.pt``, else ``None``."""
    if not os.path.isdir(log_dir):
        return None
    best, best_ep = None, -1
    for name in os.listdir(log_dir):
        match = _EPOCH_FILE.fullmatch(name)
        if match and int(match.group(1)) > best_ep:
            best, best_ep = os.path.join(log_dir, name), int(match.group(1))
    current = os.path.join(log_dir, "current.pt")
    if best is None and os.path.isfile(current):
        return current
    return best


def resume_checkpoint(log_dir: str) -> Optional[str]:
    """The checkpoint ``--auto_resume`` restores from a run directory: its
    ``current.pt``, else its newest ``ckpt_epoch_<N>.pt``, else ``None``."""
    current = os.path.join(log_dir, "current.pt")
    return current if os.path.isfile(current) \
        else latest_epoch_checkpoint(log_dir)
