"""Checkpointing: a model and its optimizer state <-> .npz with the
reference's keys.

PyTorch counterpart of ``repro/train/checkpoint.py``.  The npz holds
``p/<key>`` for each parameter, ``o/m/<key>``, ``o/v/<key>`` and
``o/step`` for the optimizer state and ``m/<name>`` for metadata, where
``<key>`` is the reference's flattened key path (``groups/0/0/attn/wq``)
and a block leaf is stacked ``(reps, ...)`` as the reference holds it
(``bridge.leaves``, ``bridge.stack``).  So a checkpoint written by
either package restores in the other.  Floats are written as float32
(numpy has no bfloat16; a bf16 value is exact in f32) and take the
template's dtype on restore, as the reference's ``restore`` casts.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import bridge


def _flat_state(opt_state):
    flat = {f"m/{k}": bridge.stack(v) for k, v in opt_state["m"].items()}
    flat.update({f"v/{k}": bridge.stack(v)
                 for k, v in opt_state["v"].items()})
    flat["step"] = bridge.stack(opt_state["step"])
    return flat


def save(path: str, model, opt_state=None, meta: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blobs = {f"p/{k}": bridge.stack(v)
             for k, v in bridge.leaves(model).items()}
    if opt_state is not None:
        blobs.update({f"o/{k}": v for k, v in _flat_state(opt_state).items()})
    if meta:
        blobs.update({f"m/{k}": np.asarray(v) for k, v in meta.items()})
    np.savez(path, **blobs)


@torch.no_grad()
def _fill(leaf, arr: np.ndarray, key: str) -> None:
    """Copy ``arr`` into ``leaf`` (a tensor, or a list of per-repetition
    tensors filled from ``arr``'s leading axis), which keeps its dtype."""
    if isinstance(leaf, list):
        if arr.shape[0] != len(leaf):
            raise ValueError(f"{key}: {arr.shape[0]} reps, template has "
                             f"{len(leaf)}")
        for t, a in zip(leaf, arr):
            _fill(t, a, key)
        return
    if tuple(leaf.shape) != arr.shape:
        raise ValueError(f"{key}: shape {arr.shape}, template "
                         f"{tuple(leaf.shape)}")
    leaf.copy_(torch.from_numpy(np.array(arr)).to(leaf.dtype))


def restore(path: str, model, opt_template=None):
    """Restores into ``model``'s parameters (and ``opt_template``'s
    moments and step), in place; returns the model, or (model, opt
    state) when a template is given."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    for key, leaf in bridge.leaves(model).items():
        _fill(leaf, data[f"p/{key}"], f"p/{key}")
    if opt_template is None:
        return model
    for part in ("m", "v"):
        for key, leaf in opt_template[part].items():
            _fill(leaf, data[f"o/{part}/{key}"], f"o/{part}/{key}")
    _fill(opt_template["step"], data["o/step"], "o/step")
    return model, opt_template
