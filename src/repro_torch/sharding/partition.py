"""Partition rules: params, caches, batches, logits; and cutting a model
or a cache to this rank's shard.

PyTorch counterpart of ``repro/sharding/partition.py``; the rules are
the reference's, rule for rule (its module docstring has the strategy):

  * tensor-parallel over ``model``: column-parallel ``wq/wk/wv``, MLP
    ``gate/up`` and the other square projections, row-parallel
    ``wo/down/cv``, vocab-sharded ``embed``/``unembed``;
  * MoE experts over ``data``, each expert's d_ff over ``model``;
  * the batch over (pod, data) whenever it divides;
  * decode KV caches by kv head over ``model`` when Hkv divides, else
    by SEQUENCE when S >= 2048;
  * a paged pool's pages by kv head over ``model`` when Hkv divides,
    else whole on every rank (its page axis is never cut);
  * everything falls back to replication when a dim does not divide.

A spec is a tuple with one entry a dim: an axis name, a tuple of axis
names (the batch over (pod, data)) or None.  The rules read names and
shapes only, so a shape-only mesh (``make_production_mesh``) takes them.

``param_specs`` gives each parameter's spec in the reference's tree
layout, keyed by the reference's key paths (``bridge.leaves``): a block
leaf carries its stacked repetition axis there, which the port holds as
one module a repetition, so ``port_spec`` drops that leading None before
a spec is applied to a port tensor (the same difference made the AdamW
decay rule take ``bridge.reference_ndim``).  Caches keep the reference's
layout in the port (``(reps, B, S, Hkv, Dh)`` leaves), so
``cache_specs`` applies as it is.

``shard_model`` and ``shard_cache`` cut a whole (global) model or cache
to this rank's slice on a host mesh; ``init_cache`` of the model under a
mesh allocates the slice directly.  ``unshard`` is the inverse, by
all-gathers.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import bridge
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.config import BLOCK_ATTN, BLOCK_MOE, ModelConfig

from . import collectives
from .rows import axes_index


def _div(n: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    s = 1
    for a in axes:
        s *= mesh.shape[a]
    return s


class P(tuple):
    """A partition spec: one entry a dim (an axis name, a tuple of axis
    names, or None); equal to the plain tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _none(ndim: int):
    return P(*(None,) * ndim)


def param_rule(name: str, shape, mesh):
    """The spec of a parameter named ``name`` (the last part of its key
    path) with the reference's ``shape``."""
    ndim = len(shape)

    def last2(a, b):
        return P(*(None,) * (ndim - 2), a, b)

    if name in ("embed", "unembed"):
        return P("model", None) if _div(shape[0], mesh, "model") \
            else P(None, None)
    if name == "vis_proj":
        return P(None, "model") if _div(shape[1], mesh, "model") \
            else P(None, None)
    if ndim < 2:
        return _none(ndim)
    if name in ("w_gate", "w_up"):            # (R, E, d, f)
        return P(None, "data" if _div(shape[1], mesh, "data") else None,
                 None, "model" if _div(shape[3], mesh, "model") else None)
    if name == "w_down":                      # (R, E, f, d)
        return P(None, "data" if _div(shape[1], mesh, "data") else None,
                 "model" if _div(shape[2], mesh, "model") else None, None)
    if name == "router":
        return _none(ndim)
    if name in ("wq", "wk", "wv", "gate", "up", "wx", "wg",
                "wr", "wi", "ck", "cr"):
        return last2(None, "model") if _div(shape[-1], mesh, "model") \
            else _none(ndim)
    if name in ("wo", "down", "cv"):
        return last2("model", None) if _div(shape[-2], mesh, "model") \
            else _none(ndim)
    if name == "conv":                        # (R, cw, w)
        return last2(None, "model") if _div(shape[-1], mesh, "model") \
            else _none(ndim)
    return _none(ndim)


def reference_shape(leaf) -> tuple:
    """A leaf of ``bridge.leaves``' shape in the reference's tree."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def param_specs(cfg: ModelConfig, model, mesh) -> Dict[str, tuple]:
    """Spec of each parameter of ``model`` (a ``Transformer`` or its
    ``bridge.leaves``), keyed by the reference's key path and in the
    reference's layout (block leaves with their repetition axis).  The
    model must be whole (global shapes): shard it after."""
    leaves = model if isinstance(model, dict) else bridge.leaves(model)
    return {key: param_rule(key.split("/")[-1], reference_shape(leaf), mesh)
            for key, leaf in leaves.items()}


def port_spec(key: str, spec: tuple) -> tuple:
    """The spec of each port tensor of leaf ``key``: a block leaf's
    (``groups/...``) without its repetition axis."""
    if key.startswith("groups/"):
        if spec[0] is not None:
            raise ValueError(f"{key}: repetition axis sharded ({spec})")
        return P(*spec[1:])
    return spec


def _tree_map(fn, tree, name=""):
    """``fn(name, leaf)`` over a tree of dicts and tuples, ``name`` the
    nearest dict key above the leaf; a spec is a leaf."""
    if isinstance(tree, P):
        return fn(name, tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v, name) for v in tree)
    return fn(name, tree)


def cache_rule(name: str, shape, mesh, baxes, seq_cut: bool = True):
    """The spec of a cache leaf named ``name`` of ``shape``; without
    ``seq_cut`` an attention leaf whose kv heads do not divide stays
    whole rather than cut along the sequence."""
    ndim = len(shape)
    if name == "pos":
        return P(baxes)
    if name in ("k", "v"):                    # (R, B, S, Hkv, Dh)
        if _div(shape[3], mesh, "model"):
            return P(None, baxes, None, "model", None)
        if seq_cut and shape[2] >= 2048 and _div(shape[2], mesh, "model"):
            return P(None, baxes, "model", None, None)
        return P(None, baxes, None, None, None)
    if name in ("k_s", "v_s"):                # int8 scales (R, B, S, Hkv)
        if _div(shape[3], mesh, "model"):
            return P(None, baxes, None, "model")
        if seq_cut and shape[2] >= 2048 and _div(shape[2], mesh, "model"):
            return P(None, baxes, "model", None)
        return P(None, baxes, None, None)
    if name == "s":                           # rwkv state (R, B, H, hs, hs)
        if _div(shape[2], mesh, "model"):
            return P(None, baxes, "model", None, None)
        return P(None, baxes, None, None, None)
    if name in ("x_tm", "x_cm", "h"):         # (R, B, d) / (R, B, w)
        return P(None, baxes, "model") if _div(shape[2], mesh, "model") \
            else P(None, baxes, None)
    if name == "conv":                        # (R, B, cw-1, w)
        return P(None, baxes, None, "model") \
            if _div(shape[3], mesh, "model") else P(None, baxes, None, None)
    return _none(ndim)


def cache_specs(cfg: ModelConfig, cache, mesh, batch: int, *,
                rows_cut: bool = True, seq_cut: bool = True):
    """Spec tree of a decode cache (leaves: tensors or anything with a
    ``shape``; the ``seq_sharded`` mark is not a leaf).  ``rows_cut``
    False keeps every row on every ``data`` rank (the serving engine's
    batch prefill cache); ``seq_cut`` False never cuts the sequence
    (``cache_rule``)."""
    baxes = batch_axes(mesh, batch) if rows_cut else None
    tree = {k: v for k, v in cache.items() if k != "seq_sharded"}
    return _tree_map(lambda name, leaf: cache_rule(
        name, tuple(leaf.shape), mesh, baxes, seq_cut), tree)


def paged_cache_specs(cfg: ModelConfig, cache, mesh, batch: int):
    """Spec tree of a paged decode cache (``init_paged_cache``): each
    attention leaf ``(R, n_pages, page, Hkv[, Dh])`` by kv head over
    ``model`` when Hkv divides, else whole, its page axis never cut (one
    replica a data rank); ``pos`` and ``block_tables`` whole on every
    rank (every rank writes every slot's token into its replica,
    ``attention.self_attn_decode_paged``); the per-slot leaves (a
    recurrent carry) follow the slots, as ``cache_rule`` cuts them."""
    baxes = batch_axes(mesh, batch)

    def pool(shape):
        heads = "model" if _div(shape[3], mesh, "model") else None
        return P(None, None, None, heads, *(None,) * (len(shape) - 4))

    groups = tuple(
        tuple({k: pool(tuple(leaf.shape)) if btype in (BLOCK_ATTN, BLOCK_MOE)
               else cache_rule(k, tuple(leaf.shape), mesh, baxes)
               for k, leaf in slot.items()}
              for btype, slot in zip(pattern, slots))
        for (pattern, _), slots in zip(cfg.block_groups(), cache["groups"]))
    return {"pos": P(None), "block_tables": P(None, None), "groups": groups}


def map_leaves(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], specs[k]) for k in specs}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def batch_specs(cfg: ModelConfig, batch_tree, mesh):
    """Input batch: the leading batch dim over (pod, data)."""

    def rule(name, leaf):
        ndim = len(leaf.shape)
        if not ndim:
            return P()
        return P(batch_axes(mesh, leaf.shape[0]), *(None,) * (ndim - 1))

    return _tree_map(rule, batch_tree)


def logits_spec(cfg: ModelConfig, mesh, batch: int, with_time: bool = False):
    baxes = batch_axes(mesh, batch)
    v_ok = _div(cfg.vocab_size, mesh, "model")
    return P(baxes, *((None,) if with_time else ()),
             "model" if v_ok else None)


# ------------------------------------------------- shards on a host mesh --
def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec, mesh) -> tuple:
    return tuple(n // _axis_size(mesh, _axes(e)) for n, e in zip(shape, spec))


def shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of the global tensor ``t``: a contiguous copy,
    or ``t`` itself when the mesh cuts none of its dims (axes of size
    1)."""
    cut = False
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        n = _axis_size(mesh, axes)
        if n > 1:
            t = t.chunk(n, dim=dim)[axes_index(mesh, axes)]
            cut = True
    return t.contiguous().clone() if cut else t


def unshard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor of which ``t`` is this rank's slice, by
    all-gathers over each sharded dim (minor axis first)."""
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            t = collectives.all_gather(t, mesh.group(a), dim)
    return t


@torch.no_grad()
def shard_model(cfg: ModelConfig, model, mesh):
    """Cut every parameter of the whole ``model`` to this rank's slice,
    in place, by ``param_specs``: each parameter carries its port spec
    (``spec``), and the model the specs by key (``shard_specs``) and the
    mesh shape it was cut for (``mesh_shape``).  Returns it."""
    if getattr(model, "mesh_shape", None) is not None:
        raise ValueError(f"model already sharded for {model.mesh_shape}")
    specs = param_specs(cfg, model, mesh)
    kept = {}
    for key, leaf in bridge.leaves(model).items():
        spec = port_spec(key, specs[key])
        kept[key] = spec
        for p in (leaf if isinstance(leaf, list) else [leaf]):
            p.data = shard(p.data, spec, mesh)
            p.spec = spec           # read by the model code (layers.axis)
    model.shard_specs = kept
    model.mesh_shape = dict(mesh.shape)
    return model


@torch.no_grad()
def unshard_leaves(tree, specs: Dict[str, tuple], mesh):
    """A tree of ``bridge.leaves``' shape (parameters, or optimizer
    moments mirroring them) whole again: each tensor all-gathered by its
    leaf's port spec."""
    return {k: [unshard(t, specs[k], mesh) for t in v]
            if isinstance(v, list) else unshard(v, specs[k], mesh)
            for k, v in tree.items()}


@torch.no_grad()
def shard_cache(cfg: ModelConfig, cache, mesh, batch: int):
    """This rank's slice of a whole decode cache (``init_cache`` /
    ``prefill`` layout), by ``cache_specs``; a sequence-cut cache is
    marked (``seq_sharded``) for the attention's decode."""
    specs = cache_specs(cfg, cache, mesh, batch)
    out = map_leaves(lambda t, spec: shard(t, spec, mesh), cache, specs)
    out["seq_sharded"] = cache_is_seq_sharded(specs)
    return out


def cache_is_seq_sharded(specs) -> bool:
    """True when a spec tree puts ``model`` on an attention leaf's
    sequence dim."""
    found = []
    _tree_map(lambda name, s: found.append(
        name in ("k", "v") and len(s) == 5 and s[2] == "model"), specs)
    return any(found)
