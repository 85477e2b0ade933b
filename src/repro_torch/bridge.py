"""Convert the reference's parameter and cache pytrees to the port, and
back, through numpy.

The caller turns the reference's JAX arrays into numpy first (for
example ``jax.tree.map(np.asarray, params)``), so this module never sees
JAX.  Leaves are named by the key paths of the reference's
``train/checkpoint.py::_flatten``: dict keys and tuple indices joined by
``/`` (``groups/0/0/attn/wq``, ``groups/0/0/rwkv/w0``).  Block-group
leaves are stacked ``(reps, ...)``; they are unstacked into
``Transformer.groups[gi][j]``.

Every leaf keeps the dtype the port gives it: the model's dtype, except
the RWKV decay path and bonus (``w0``, ``wA``, ``wB``, ``u``), the
RG-LRU gates and decay (``wr``, ``wi``, ``lam``), the MoE router
(``groups/<g>/<j>/moe/router``) and the recurrent carries ``s`` (RWKV)
and ``h`` (RG-LRU), which are float32 in a bf16 model too, as in the
reference.  The MoE experts (``moe/w_gate``, ``moe/w_up`` (E, d, f),
``moe/w_down`` (E, f, d)) and the shared expert (``moe/shared/{gate,
up,down}``) land once, at load, in the reference's layout, which is the
one the grouped product takes (``models/moe.py:grouped_mm``).  A VLM's
``vis_proj`` (d_vision, d_model) is a top-level leaf; each cross layer's
``attn/gate`` is stacked ``(reps,)`` and lands as a 0-d leaf a block; a
squared-ReLU MLP (nemotron) has ``up`` and ``down`` only.

The way back: :func:`leaves` names each of a model's parameters by its
reference key path, a block leaf as the list of its per-repetition
tensors (what the trainer's optimizer state mirrors), and
:func:`params_to_numpy` stacks those lists into the reference's
``(reps, ...)`` tree, which ``train/checkpoint.py`` writes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models import rglru, rwkv
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Key-path flattening of nested dicts/tuples/lists of arrays."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat = {}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


@torch.no_grad()
def params_from_numpy(tree, cfg: ModelConfig, device="cuda",
                      dtype=torch.float32) -> Transformer:
    """The port's :class:`Transformer` holding the reference's weights."""
    model = Transformer(cfg, dtype, device)
    flat = flatten(tree)
    filled = set()
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "groups":
            gi, j, rest = int(parts[1]), int(parts[2]), ".".join(parts[3:])
            slot = model.groups[gi][j]
            if arr.shape[0] != len(slot):
                raise ValueError(f"{key}: {arr.shape[0]} reps, model has "
                                 f"{len(slot)}")
            for rep, blk in enumerate(slot):
                _copy(blk.get_parameter(rest), arr[rep], key)
                filled.add(f"groups.{gi}.{j}.{rep}.{rest}")
        else:
            name = ".".join(parts)
            _copy(model.get_parameter(name), arr, key)
            filled.add(name)
    missing = {n for n, _ in model.named_parameters()} - filled
    if missing:
        raise ValueError(f"parameters not in the tree: {sorted(missing)}")
    return model


def _copy(param: torch.Tensor, arr: np.ndarray, key: str) -> None:
    """Copy into ``param``, which keeps its own dtype."""
    if tuple(param.shape) != arr.shape:
        raise ValueError(f"{key}: shape {arr.shape}, port expects "
                         f"{tuple(param.shape)}")
    param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))


def cache_from_numpy(tree, device="cuda", dtype=None):
    """A reference cache pytree (numpy leaves) as torch tensors with the
    same structure; float leaves take ``dtype`` when it is given, except
    a recurrent block's f32 carry (``rwkv.F32_STATE_LEAVES``,
    ``rglru.F32_STATE_LEAVES``)."""
    if isinstance(tree, dict):
        f32 = next((mod.F32_STATE_LEAVES for mod in (rwkv, rglru)
                    if set(tree) == set(mod.STATE_LEAVES)), ())
        return {k: cache_from_numpy(
                    v, device, torch.float32 if dtype is not None
                    and k in f32 else dtype)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(cache_from_numpy(v, device, dtype) for v in tree)
    t = torch.from_numpy(np.array(tree)).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def cache_to_numpy(tree):
    """Inverse of :func:`cache_from_numpy` (f32 for float leaves)."""
    if isinstance(tree, dict):
        return {k: cache_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(cache_to_numpy(v) for v in tree)
    if tree.is_floating_point():
        tree = tree.float()
    return tree.detach().cpu().numpy()


def leaves(model: Transformer) -> Dict[str, object]:
    """Each parameter of ``model`` by its reference key path: a top-level
    leaf (``embed``, ``unembed``, ``ln_f``, ``vis_proj``) as its tensor,
    a block leaf (``groups/<g>/<j>/...``) as the list of its tensors, one
    a repetition, in repetition order (the reference stacks them on a
    leading axis).  Sorted by key, as :func:`flatten` orders them."""
    out: Dict[str, object] = {}
    for name, param in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "groups":
            gi, j, rep = parts[1:4]
            key = "/".join(["groups", gi, j] + parts[4:])
            out.setdefault(key, []).append((int(rep), param))
        else:
            out["/".join(parts)] = param
    return {k: [p for _, p in sorted(v)] if isinstance(v, list) else v
            for k, v in sorted(out.items())}


def reference_ndim(leaf) -> int:
    """The rank of a leaf of :func:`leaves` in the reference's tree: a
    block leaf's own rank plus its stacked repetition axis."""
    if isinstance(leaf, list):
        return leaf[0].dim() + 1
    return leaf.dim()


def stack(leaf) -> np.ndarray:
    """A leaf of :func:`leaves` (or of a tree shaped like it) as the
    reference's numpy array: a list stacked on a leading axis; float
    leaves as float32 (numpy has no bfloat16; f32 holds a bf16 value
    exactly, and the reference's restore casts to its template's
    dtype)."""
    if isinstance(leaf, list):
        return np.stack([stack(x) for x in leaf])
    t = leaf.detach()
    if t.is_floating_point():
        t = t.float()
    return t.cpu().numpy()


def unflatten(flat: Dict[str, np.ndarray]):
    """The nested tree of :func:`flatten`'s key paths: dicts, with the
    reference's ``groups`` as a tuple (groups) of tuples (pattern slots)
    of dicts."""
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    if "groups" in tree:
        g = tree["groups"]
        tree["groups"] = tuple(tuple(g[str(gi)][str(j)]
                                     for j in range(len(g[str(gi)])))
                               for gi in range(len(g)))
    return tree


def params_to_numpy(model: Transformer):
    """The reference's parameter tree (numpy leaves, block leaves stacked
    ``(reps, ...)``) of ``model``: the inverse of
    :func:`params_from_numpy`."""
    return unflatten({k: stack(v) for k, v in leaves(model).items()})
