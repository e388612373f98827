"""Flax variables -> the port's ``state_dict``.

The port's module names follow the Flax parameter tree, so a leaf at
``params/A/B/Dense_0/kernel`` becomes ``A.B.Dense_0.weight``.  Mappings:

============================  ======================================
Flax                          torch
============================  ======================================
``Dense`` kernel (in, out)    ``weight`` (out, in), transposed
``Dense`` bias                ``bias``
BatchNorm ``scale``/``bias``  ``weight``/``bias``
BatchNorm ``mean``/``var``    ``running_mean``/``running_var``
PseudoGrid ``kernel_weights``  as is, (P, C)
============================  ======================================

BatchNorm's ``num_batches_tracked`` has no Flax counterpart and is set to
0.  A leaf that fits none of these raises; so does, when ``model`` is given,
a key that the model lacks or leaves unfilled.

:func:`adam_state_from_optax` carries an optax Adam state (``count``,
``mu``, ``nu``) over to ``torch.optim.Adam``'s, by the same name table, so
that a run of the JAX package can go on in the port.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(variables: Mapping[str, Any],
                     model: Optional[nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
    """Convert ``{"params": ..., "batch_stats": ...}`` (numpy leaves) to a
    ``state_dict`` for the port's module of the same structure."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            *mods, leaf = path
            owner = mods[-1] if mods else ""
            arr = np.array(value, dtype=np.float32)  # a writable copy
            base = ".".join(mods)
            if collection == "params" and owner.startswith("Dense_") \
                    and leaf == "kernel":
                name, arr = "weight", arr.T
            elif collection == "params" and owner.startswith("Dense_") \
                    and leaf == "bias":
                name = "bias"
            elif collection == "params" \
                    and owner.startswith("BatchNorm_") \
                    and leaf in ("scale", "bias"):
                name = "weight" if leaf == "scale" else "bias"
            elif collection == "batch_stats" \
                    and owner.startswith("BatchNorm_") \
                    and leaf in ("mean", "var"):
                name = "running_" + leaf
            elif collection == "params" and leaf == "kernel_weights":
                base, name = ".".join(mods), "kernel_weights"
            else:
                raise KeyError(f"no torch counterpart for Flax leaf "
                               f"{collection}/{'/'.join(path)}")
            key = f"{base}.{name}" if base else name
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
            if name == "running_mean":
                sd[f"{base}.num_batches_tracked"] = torch.tensor(0)
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(sd))
        extra = sorted(set(sd) - set(want))
        if missing or extra:
            raise KeyError(f"Flax variables do not match the model: "
                           f"missing {missing[:8]}, unused {extra[:8]}")
        for k, v in sd.items():
            if tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(f"{k}: Flax shape {tuple(v.shape)}, model "
                                 f"shape {tuple(want[k].shape)}")
    return sd


def adam_state_from_optax(count, mu: Mapping[str, Any],
                          nu: Mapping[str, Any], model: nn.Module,
                          optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.load_state_dict`` input from the fields of optax's
    ``ScaleByAdamState``, as numpy: ``count`` (updates done) and the
    moment trees ``mu`` and ``nu`` of the Flax parameter tree's structure.

    ``optimizer`` is a ``torch.optim.Adam`` (or ``AdamW``) over
    ``model.parameters()`` in their order, in one group; its hyperparameters
    are kept.  Each parameter's ``step`` is ``count``; ``exp_avg`` and
    ``exp_avg_sq`` are ``mu`` and ``nu``, ``Dense`` kernels transposed.
    """
    moments = [params_from_flax({"params": tree}) for tree in (mu, nu)]
    names = [n for n, _ in model.named_parameters()]
    for sd in moments:
        if set(sd) != set(names):
            raise KeyError(
                f"optax moments do not match the model's parameters: "
                f"missing {sorted(set(names) - set(sd))[:8]}, unused "
                f"{sorted(set(sd) - set(names))[:8]}")
    template = optimizer.state_dict()
    groups = template["param_groups"]
    if len(groups) != 1 or len(groups[0]["params"]) != len(names):
        raise ValueError("the optimizer must hold the model's parameters "
                         "in one group")
    step = torch.tensor(float(np.asarray(count)))
    state = {
        pid: {"step": step.clone(), "exp_avg": moments[0][name].clone(),
              "exp_avg_sq": moments[1][name].clone()}
        for pid, name in zip(groups[0]["params"], names)}
    return {"state": state, "param_groups": groups}


def flax_from_params(state_dict: Mapping[str, torch.Tensor]
                     ) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax`, for round trips."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        *mods, name = key.split(".")
        owner = mods[-1] if mods else ""
        if name == "num_batches_tracked":
            continue
        arr = value.detach().cpu().numpy()
        if owner.startswith("Dense_") and name == "weight":
            coll, leaf, arr = "params", "kernel", arr.T
        elif owner.startswith("Dense_") and name == "bias":
            coll, leaf = "params", "bias"
        elif owner.startswith("BatchNorm_") and name in ("weight", "bias"):
            coll, leaf = "params", "scale" if name == "weight" else "bias"
        elif owner.startswith("BatchNorm_") and name.startswith("running_"):
            coll, leaf = "batch_stats", name[len("running_"):]
        elif name == "kernel_weights":
            coll, leaf = "params", name
        else:
            raise KeyError(f"no Flax counterpart for {key}")
        node = out[coll]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out
