"""Mixture-of-Experts FFN: top-k routing, the dense oracle and the
sort-based grouped path.

PyTorch counterpart of ``repro/models/moe.py``:

* ``moe_dense_ref`` — every expert applied to every token, combined with
  the top-k gates' one-hot in f32.  O(E) FLOPs: the correctness oracle
  (``moe_impl="ref"``).
* ``moe_local`` — the (token, expert) pairs stably sorted by expert, the
  three projections as grouped products over the sorted rows, the
  inverse permutation, then the gate-weighted sum over k in f32.  Active
  FLOPs only (``moe_impl="local"``, the default).
* ``moe_ep`` — the reference's expert-parallel all-to-all path arrives
  with the distribution slice of the port; here it raises.

The grouped product (``grouped_mm``) is where the reference calls
``jax.lax.ragged_dot``, an XLA op and not a Pallas kernel.  Its route is
chosen by the operands, never by catching a failure:

* bf16 on the card: one ``torch.nn.functional.grouped_mm`` call a
  projection.  Its group offsets stay on the card, so nothing reads
  back to the host and the decode step's CUDA graph captures it.
* f32 on the card (the smoke parity runs): that call would read the
  offsets back to the host, so the plain version runs instead, a loop
  over the E experts that keeps each expert's product on its own
  segment of rows (``grouped_mm_plain``), which the graph captures too.
* the CPU: the plain version.

``runtime.grouped_counts`` counts the card's calls by route, as the
kernel wrappers count their launches.

Under autograd the bf16 route is :class:`GroupedMM`, the reference's
custom VJP of its grouped product (``ragged_matmul``): ``dx`` is the
grouped product of ``dy`` with each group's ``wᵀ``, ``dw`` the product
contracted over each group's rows, ``xᵀ dy`` a group, which
``grouped_mm`` computes in its 2-D x 2-D form with the same offsets
(``runtime.autograd_counts["grouped_mm"]`` counts these backward
passes).  The plain masked loop is plain autograd.

Routing is a top-k softmax over f32 router logits, re-normalized over
the k chosen (qwen3), with an always-on shared expert where the config
has one (llama4-scout).  The router stays f32 in a bf16 model.
Counting the experts' rows uses ``scatter_add_``, never ``bincount``,
``nonzero`` or ``unique``, which read back to the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import runtime

from . import layers
from .config import ModelConfig
from .layers import KeepsF32, frozen_param as _param

IMPLS = ("local", "ref", "ep")


class Moe(KeepsF32):
    """Router (d, E) f32, experts ``w_gate``/``w_up`` (E, d, f) and
    ``w_down`` (E, f, d) in the model's dtype, the reference's layout:
    the grouped product takes them as they are stored, so nothing is
    transposed per call.  ``shared`` is the shared expert's MLP."""

    FAMILY = "MoE"
    F32_LEAVES = ("router",)

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
        e = dict(dtype=dtype, device=device)
        self.router = _param(torch.empty(d, E, dtype=torch.float32,
                                         device=device))
        self.w_gate = _param(torch.empty(E, d, f, **e))
        self.w_up = _param(torch.empty(E, d, f, **e))
        self.w_down = _param(torch.empty(E, f, d, **e))
        if cfg.shared_expert:
            self.shared = layers.MLP(cfg, "silu", dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        """``moe_init``'s scales: ``dense_init`` for the router, normal
        times d^-0.5 for the gate and up weights and f^-0.5 for the down
        weights, drawn expert by expert (no f32 copy of a whole expert
        tensor is made)."""
        d, E = self.router.shape
        f = self.w_gate.shape[2]
        self.router.copy_(layers.dense_init(gen, d, E, torch.float32))
        for w, scale in ((self.w_gate, d ** -0.5), (self.w_up, d ** -0.5),
                         (self.w_down, f ** -0.5)):
            for i in range(E):
                w[i].copy_(layers.dense_init(gen, w.shape[1], w.shape[2],
                                             w.dtype, scale=scale))
        if hasattr(self, "shared"):
            self.shared.init_(gen)


def check_impl(impl: str) -> None:
    """Refuse what the port does not run: ``"ep"`` needs the
    distribution slice."""
    if impl == "ep":
        raise NotImplementedError(
            "moe_impl='ep' (expert parallelism over an all-to-all) arrives "
            "with the distribution slice of the port")
    if impl not in IMPLS:
        raise ValueError(f"moe_impl {impl!r}: one of {IMPLS}")


def router_topk(cfg: ModelConfig, p, x):
    """x: (T,d) -> gates (T,k) f32, idx (T,k) int64, router probs (T,E)."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_norm_topk:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs


def load_balance_loss(cfg: ModelConfig, probs, idx):
    """Switch-style auxiliary loss: E times the dot product of the mean
    router probability and the share of routed pairs, per expert."""
    E = cfg.n_experts
    me = probs.mean(0)
    flat = idx.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=probs.device)
    ce.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                      device=probs.device))
    ce = ce / max(idx.numel(), 1)
    return E * torch.sum(me * ce)


def _one_hot(idx, n: int):
    """f32 one-hot by comparison (``F.one_hot`` checks the ids on the
    host for a CPU tensor)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _expert_ffn_dense(p, x):
    """x: (T,d) -> (T,E,d): every expert applied to every token."""
    g = torch.einsum("td,edf->tef", x, p["w_gate"])
    u = torch.einsum("td,edf->tef", x, p["w_up"])
    h = F.silu(g) * u
    return torch.einsum("tef,efd->ted", h, p["w_down"])


def moe_dense_ref(cfg: ModelConfig, p, x):
    """Oracle path. x: (B,T,d)."""
    B, T, d = x.shape
    xt = x.reshape(B * T, d)
    gates, idx, _ = router_topk(cfg, p, xt)
    all_out = _expert_ffn_dense(p, xt)                        # (N,E,d)
    comb = torch.einsum("tk,tke->te", gates, _one_hot(idx, cfg.n_experts))
    out = torch.einsum("te,ted->td", comb, all_out.float()).to(x.dtype)
    if cfg.shared_expert:
        out = out + layers.mlp_apply(p["shared"], xt, "silu")
    return out.reshape(B, T, d)


def group_offsets(flat_e, E: int):
    """Cumulative row ends (E,) int32 of the experts' segments, counted on
    the device."""
    sizes = torch.zeros(E, dtype=torch.int32, device=flat_e.device)
    sizes.scatter_add_(0, flat_e, torch.ones(flat_e.shape, dtype=torch.int32,
                                             device=flat_e.device))
    return torch.cumsum(sizes, 0, dtype=torch.int32)


def grouped_mm_plain(x, w, offs):
    """Plain grouped product: rows ``[offs[e-1], offs[e])`` of x (M, K)
    times w[e] (K, N).  One product an expert over all rows, kept on the
    expert's segment; the offsets are compared on the device."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    starts = torch.cat([offs.new_zeros(1), offs[:-1]])
    out = x.new_zeros((x.shape[0], w.shape[2]))
    for e in range(w.shape[0]):
        seg = (rows >= starts[e]) & (rows < offs[e])
        out = torch.where(seg, x @ w[e], out)
    return out


class GroupedMM(torch.autograd.Function):
    """``F.grouped_mm(x, w, offs=offs)`` with the reference's backward:
    ``dx = grouped(dy, wᵀ)``, ``dw[e] = x[rows of e]ᵀ dy[rows of e]``
    (zero for an empty group)."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        return F.grouped_mm(x, w, offs=offs)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs = ctx.saved_tensors
        dy = dy.contiguous()
        runtime.autograd_counts["grouped_mm"] += 1
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = F.grouped_mm(dy, w.transpose(1, 2), offs=offs)
        if ctx.needs_input_grad[1]:
            dw = F.grouped_mm(x.t(), dy, offs=offs)
        return dx, dw, None


def grouped_mm(x, w, offs):
    """x (M, K) rows sorted by group; w (E, K, N); offs (E,) int32 row
    ends, offs[-1] == M.  Returns (M, N) in x's dtype."""
    if not x.is_cuda:
        return grouped_mm_plain(x, w, offs)
    if x.dtype == torch.bfloat16:
        runtime.grouped_counts["grouped_mm"] += 1
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return GroupedMM.apply(x, w, offs)
        return F.grouped_mm(x, w, offs=offs)
    runtime.grouped_counts["masked_loop"] += 1
    return grouped_mm_plain(x, w, offs)


def grouped_ffn(p, xs, offs):
    """The experts' gated FFN over rows sorted by expert: three grouped
    products, ``silu(g) * u`` in f32 between them, cast back."""
    g = grouped_mm(xs, p["w_gate"], offs)
    u = grouped_mm(xs, p["w_up"], offs)
    h = (F.silu(g.float()) * u.float()).to(xs.dtype)
    return grouped_mm(h, p["w_down"], offs)


def moe_local(cfg: ModelConfig, p, x):
    """Sort + grouped product path (active FLOPs only). x: (B,T,d)."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(B * T, d)
    gates, idx, _ = router_topk(cfg, p, xt)
    flat_e = idx.reshape(-1)                                  # (N*k,)
    order = torch.argsort(flat_e, stable=True)      # jnp.argsort is stable
    xs = xt.index_select(0, order // k)                       # (N*k, d)
    ys = grouped_ffn(p, xs, group_offsets(flat_e, E))
    ys = torch.empty_like(ys).index_copy_(0, order, ys)       # unsort
    ys = ys.reshape(-1, k, d).float()
    out = (ys * gates[..., None]).sum(1).to(x.dtype)
    if cfg.shared_expert:
        out = out + layers.mlp_apply(p["shared"], xt, "silu")
    return out.reshape(B, T, d)


def moe_ep(cfg: ModelConfig, p, x, **_):
    check_impl("ep")


def apply(cfg: ModelConfig, p, x, impl: str = "local"):
    """The MoE FFN by ``impl`` (the reference's ``_apply_moe``)."""
    check_impl(impl)
    if impl == "ref":
        return moe_dense_ref(cfg, p, x)
    return moe_local(cfg, p, x)
