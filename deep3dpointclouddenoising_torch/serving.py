"""Sealed serving artifacts: the denoiser's forward exported by
``torch.export`` with its weights inside.

Counterpart of ``deep3dpointclouddenoising_tpu/serving.py``, with its
functions and its sidecar metadata.  An artifact is the eval forward at one
fixed (batch, points) shape, exported as inference runs it
(``infer.make_predict_fn``): eval-mode BatchNorm statistics, the
``cfg.norm`` input and output scaling folded in, and full-cleaning outputs
left raw for the tanh and sigmoid that ``infer.clean_clouds`` applies.  The
weights ride in the artifact, so a serving process needs no model code,
config or checkpoint.

The KPConv kernels are the custom ops ``d3pcd_torch::kpconv_fwd`` and
``d3pcd_torch::kpconv_bwd`` (``ops/kpconv.py``); an exported program holds
them as opaque nodes, and the exported forward launches
``csrc/kpconv_fwd.cu`` on the card as the eager one does.  So, unlike a
JAX artifact, loading one needs the port's op library imported, to
register the ops: this module imports ``ops/kpconv.py``, whose kernels are
built from ``csrc/`` at first use.  Nothing else of the port is needed.

``torch.export`` traces with static shapes: the 15,000-slot configs export
too, since their queries do not compact the supports under export
(``ops.neighbors.auto_compact``).  An artifact runs on the device it was
exported for (``platforms`` in the sidecar: ``["cuda"]`` or ``["cpu"]``).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .ops import kpconv  # noqa: F401  (registers the KPConv custom ops)

FORMAT_VERSION = 1
_META_SUFFIX = ".json"
_INPUTS = ("points", "mask", "features")


class ServingForward(torch.nn.Module):
    """``(points, mask, features) -> (B, N, out)``: the eval model with
    ``infer.make_predict_fn``'s scaling, out of place."""

    def __init__(self, model: torch.nn.Module,
                 norm_factor: Optional[float] = None,
                 scale_outputs: bool = True):
        super().__init__()
        self.model = model.eval()
        self.norm_factor = norm_factor
        self.scale_outputs = scale_outputs

    def forward(self, points: torch.Tensor, mask: torch.Tensor,
                features: torch.Tensor) -> torch.Tensor:
        f = self.norm_factor
        if f:
            points = points / f
            features = features / f
        out = self.model(points, mask, features)
        if f and self.scale_outputs:
            # offsets live in the first 3 channels; a 4th full-cleaning
            # channel is an outlierness logit and is not scaled
            out = torch.cat([out[..., :3] * f, out[..., 3:]], dim=-1)
        return out


def make_serving_forward(model: torch.nn.Module,
                         norm_factor: Optional[float] = None,
                         scale_outputs: bool = True) -> ServingForward:
    """The sealed forward around ``model`` (put in eval mode)."""
    return ServingForward(model, norm_factor, scale_outputs)


def _example_tensors(example: Dict[str, Any], device: torch.device):
    """The batch's inputs (numpy arrays or tensors) as tensors on
    ``device``."""
    return tuple(x.to(device) if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (example[k] for k in _INPUTS))


def export_denoiser(model: torch.nn.Module, example: Dict[str, Any],
                    norm_factor: Optional[float] = None,
                    scale_outputs: bool = True,
                    device: Optional[torch.device] = None
                    ) -> torch.export.ExportedProgram:
    """Export the denoiser's forward as a ``torch.export.ExportedProgram``.

    Args:
      model: the offset or full-cleaning model; moved to ``device``.
      example: a batch dict with ``points (B,N,3)``, ``mask (B,N)`` and
        ``features (B,N,F)``; only shapes and dtypes are read, and they are
        the artifact's.
      device: where the artifact runs (default: the model's device).
    """
    device = torch.device(device) if device is not None \
        else next(model.parameters()).device
    fwd = make_serving_forward(model.to(device), norm_factor, scale_outputs)
    with torch.no_grad():
        return torch.export.export(fwd, _example_tensors(example, device),
                                   strict=False)


def _aval(t: torch.Tensor) -> str:
    """``float32[16,500,3]``, as JAX prints an abstract value."""
    return f"{str(t.dtype).replace('torch.', '')}" \
           f"[{','.join(str(int(d)) for d in t.shape)}]"


def _avals(exported: torch.export.ExportedProgram):
    """The abstract values of the user inputs and outputs."""
    sig = exported.graph_signature
    nodes = {n.name: n for n in exported.graph.nodes}
    ins = [_aval(nodes[name].meta["val"]) for name in sig.user_inputs]
    out_node = next(n for n in exported.graph.nodes if n.op == "output")
    outs = [_aval(v.meta["val"]) for v in out_node.args[0]
            if isinstance(v, torch.fx.Node)]
    return ins, outs


def _artifact_device(exported: torch.export.ExportedProgram) -> torch.device:
    """The device of the artifact's weights (where it runs)."""
    for t in exported.state_dict.values():
        return t.device
    return torch.device("cpu")


def save_artifact(exported: torch.export.ExportedProgram, path: str,
                  meta: Optional[Dict[str, Any]] = None) -> None:
    """Write the artifact (``torch.export.save``) and a sidecar metadata
    json (shapes, platforms, format version) for deploy-time checks."""
    torch.export.save(exported, path)
    ins, outs = _avals(exported)
    info = {
        "format_version": FORMAT_VERSION,
        "fn_name": f"{ServingForward.__name__}.forward",
        "platforms": [_artifact_device(exported).type],
        "in_avals": ins,
        "out_avals": outs,
        "nr_devices": 1,
        "bytes": os.path.getsize(path),
    }
    if meta:
        info.update(meta)
    with open(path + _META_SUFFIX, "w") as f:
        json.dump(info, f, indent=1)


def load_denoiser(path: str):
    """Load an artifact and return ``predict(points, mask, features)``:
    numpy arrays or tensors in, a tensor on the artifact's device out (the
    caller decides when to wait for it), under ``torch.inference_mode``.
    ``predict.exported`` is the ``ExportedProgram``."""
    exported = torch.export.load(path)
    module = exported.module()
    device = _artifact_device(exported)

    def predict(points, mask, features):
        with torch.inference_mode():
            return module(*_example_tensors(
                dict(points=points, mask=mask, features=features), device))

    predict.exported = exported
    return predict


def artifact_meta(path: str) -> Dict[str, Any]:
    with open(path + _META_SUFFIX) as f:
        return json.load(f)
