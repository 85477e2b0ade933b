"""Shared layer primitives: norms, RoPE, MLPs, embeddings, init helpers.

PyTorch counterpart of ``repro/models/layers.py``.  Weights keep the
reference layout — projections are ``(d_in, d_out)`` and applied as
``x @ w`` — so parameters convert one to one through numpy.

Under a mesh (``sharding/partition.py:shard_model``) each parameter
holds this rank's slice and carries its spec; :func:`axis` reads it.
The MLP, the embedding and the head then run tensor-parallel over the
``model`` axis with the collectives of ``sharding/collectives.py``: a
column-parallel ``gate``/``up`` and a row-parallel ``down`` followed by
an all-reduce; a vocab-sharded embedding (a masked local lookup, then an
all-reduce) and head (local logits, then an all-gather of the vocab).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import collectives


def axis(w, dim: int) -> Optional[str]:
    """The mesh axis (a name) that dim ``dim`` of parameter ``w`` is cut
    over, None when it is whole or the model is not sharded."""
    spec = getattr(w, "spec", None)
    return None if spec is None else spec[dim]


def model_group(mesh, w, dim: int):
    """The ``model`` axis's process group when ``w``'s dim ``dim`` is cut
    over it, else None."""
    if mesh is None or axis(w, dim) != "model":
        return None
    return mesh.group("model")


def column(x, w, mesh):
    """``x @ w``: this rank's columns where ``w`` is column-parallel over
    ``model`` (its replicated input's gradient all-reduced)."""
    g = model_group(mesh, w, -1)
    return x @ w if g is None else collectives.copy_to(x, g) @ w


def whole(y, w, mesh):
    """``y``, a product with ``w``, whole: all-gathered over ``model``
    where ``w`` is column-parallel (its gradient then this rank's
    columns)."""
    g = model_group(mesh, w, -1)
    return y if g is None else collectives.gather_from(y, g, -1)


def row(h, w, mesh):
    """``h @ w``; where ``w`` is row-parallel over ``model``, this rank's
    partial sums all-reduced in f32."""
    y = h @ w
    g = model_group(mesh, w, 0)
    if g is None:
        return y
    return collectives.reduce_from(y.float(), g).to(y.dtype)


def own(t, mesh, dim: int = -1):
    """This rank's ``model`` part of a replicated tensor along ``dim``,
    for a product with a cut weight; its gradient is all-reduced over
    ``model``, so that the replicated leaf's is whole on every rank."""
    m, r = mesh.size("model"), mesh.coord("model")
    n = t.shape[dim] // m
    return collectives.copy_to(t, mesh.group("model")).narrow(dim, r * n, n)


def frozen_param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Params(nn.Module):
    """A module whose parameters are also read as ``p["name"]``, the
    reference's dict access, so the block functions port unchanged."""

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class KeepsF32(Params):
    """Params whose ``F32_LEAVES`` are float32 whatever the model's
    dtype, as the reference keeps them.  ``model.to(torch.bfloat16)``
    would cast them and change the model: it is refused before anything
    moves."""

    FAMILY = ""
    F32_LEAVES: tuple = ()

    def _apply(self, fn, recurse=True):
        leaf = getattr(self, self.F32_LEAVES[0])
        probe = fn(torch.zeros(1, dtype=torch.float32, device=leaf.device))
        if probe.dtype != torch.float32:
            raise TypeError(
                f"{self.FAMILY} parameters {self.F32_LEAVES} stay float32; "
                f"build the model in the dtype wanted (init_params / "
                f"params_from_numpy dtype=...) instead of casting it to "
                f"{probe.dtype}")
        return super()._apply(fn, recurse)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """Normal(0, scale²) weight of shape ``(d_in, d_out)`` on the
    generator's device (``scale`` defaults to ``d_in ** -0.5``)."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype):
    return dense_init(gen, vocab, d_model, dtype, scale=d_model ** -0.5)


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm over the last axis, scaled by ``(1 + w)``, in f32."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + w.float())).to(dt)


def head_rms_norm(x, w, eps: float = 1e-6):
    """Per-head RMSNorm over d_head (qwen3 qk-norm). x: (..., H, Dh)."""
    return rms_norm(x, w, eps)


# ---------------------------------------------------------------- RoPE ----
def rope_angles(positions, d_head: int, theta: float):
    """positions: (...,) int -> cos, sin of shape (..., d_head//2), f32."""
    half = d_head // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a Python-float base: a tensor made from ``theta`` on the card would
    # be a host-to-device copy, which synchronises the stream every layer
    freqs = torch.pow(float(theta), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Rotate half-split halves. x: (B, T, H, Dh); cos/sin: (B, T, Dh//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    while cos.ndim < x.ndim:
        cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------- MLP ----
class MLP(Params):
    """MLP weights ``up`` (d, d_ff) and ``down`` (d_ff, d), and for a
    gated activation (``silu``, ``gelu``) also ``gate`` (d, d_ff); the
    squared-ReLU MLP (``sq_relu``) has no gate, as the reference's
    ``mlp_init``."""

    def __init__(self, cfg, act: str, dtype, device):
        super().__init__()
        e = dict(dtype=dtype, device=device)
        if act != "sq_relu":
            self.gate = frozen_param(torch.empty(cfg.d_model, cfg.d_ff, **e))
        self.up = frozen_param(torch.empty(cfg.d_model, cfg.d_ff, **e))
        self.down = frozen_param(torch.empty(cfg.d_ff, cfg.d_model, **e))

    def init_(self, gen: torch.Generator) -> None:
        for _, w in self.named_parameters():
            w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype))


def mlp_apply(p, x, act: str, mesh=None, reduce: bool = True):
    """``relu(x @ up)² @ down`` for ``sq_relu``; otherwise the gated
    ``(act(x @ gate) * (x @ up)) @ down``.  With d_ff cut over the mesh's
    ``model`` axis, this rank's columns and rows, then the all-reduce of
    the partial sums (``reduce=False`` leaves them to the caller)."""
    g_tp = model_group(mesh, p["up"], -1)
    if g_tp is not None:
        x = collectives.copy_to(x, g_tp)
    if act == "sq_relu":
        h = torch.relu(x @ p["up"])
        out = (h * h) @ p["down"]
    else:
        h = x @ p["up"]
        g = x @ p["gate"]
        if act == "silu":
            g = F.silu(g)
        elif act == "gelu":
            g = F.gelu(g, approximate="tanh")    # jax.nn.gelu's default
        else:
            raise ValueError(act)
        out = (g * h) @ p["down"]
    if g_tp is None or not reduce:
        return out
    return collectives.reduce_from(out, g_tp)


# ----------------------------------------------------------- embedding ----
def embed_apply(emb, tokens, mesh=None):
    """Row gather.  Out-of-range ids are clamped into the vocabulary
    here; the reference's ``jnp.take`` (JAX's default ``mode="fill"``)
    gives NaN rows for them instead.  No serving path feeds such ids.
    A vocab-sharded table looks up the ids in this rank's rows (zero
    elsewhere) and all-reduces over ``model``."""
    g = model_group(mesh, emb, 0)
    if g is None:
        return F.embedding(tokens.clamp(0, emb.shape[0] - 1), emb)
    v_loc = emb.shape[0]
    vocab = v_loc * mesh.size("model")
    local = tokens.clamp(0, vocab - 1) - mesh.coord("model") * v_loc
    mine = (local >= 0) & (local < v_loc)
    rows = F.embedding(local.clamp(0, v_loc - 1), emb)
    return collectives.reduce_from(torch.where(mine[..., None], rows, 0), g)


class _HeadMM(torch.autograd.Function):
    """``x @ wᵀ`` of two low-precision operands with an f32 result;
    torch gives this product no derivative, so the backward is written
    out: the f32 gradient rounded to the operands' dtype, then
    ``dx = g w`` and ``dw = gᵀ x``."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x2, w = ctx.saved_tensors
        g = grad.to(w.dtype)
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = g.t() @ x2 if ctx.needs_input_grad[1] else None
        return dx, dw


def unembed_apply(w, x, mesh=None):
    """w: (vocab, d) head; returns f32 logits.

    On the card a low-precision head is multiplied in its own dtype with
    an f32 output, so no f32 copy of the (vocab, d) head is made per
    step (under autograd through :class:`_HeadMM`); elsewhere the
    product runs in f32, as the reference does.  A vocab-sharded head
    gives this rank's logits, all-gathered over ``model``."""
    g = model_group(mesh, w, 0)
    if g is not None:
        x = collectives.copy_to(x, g)
        return collectives.gather_from(_unembed(w, x), g, -1)
    return _unembed(w, x)


def _unembed(w, x):
    if w.is_cuda and w.dtype != torch.float32:
        x2 = x.reshape(-1, x.shape[-1]).to(w.dtype)
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
            out = _HeadMM.apply(x2, w)
        else:
            out = torch.mm(x2, w.t(), out_dtype=torch.float32)
        return out.reshape(x.shape[:-1] + (w.shape[0],))
    return x.float() @ w.float().t()
