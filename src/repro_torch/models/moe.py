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
* ``moe_ep`` — expert parallel under a mesh (``moe_impl="ep"``): the
  experts cut over the ``data`` axis, each expert's d_ff over ``model``
  (``sharding/partition.py``).  The (token, expert) pairs go to the rank
  owning their expert in fixed-capacity buckets by an all-to-all over
  ``data``, through the grouped FFN of that rank's experts, partial sums
  all-reduced over ``model`` in f32, and back by the return all-to-all;
  the reference's arithmetic (capacity, stable order, dropped overflow,
  the f32 combine).  Empty slots carry no expert: they sort after every
  real row, past the grouped product's last offset, so no expert
  computes them (the reference runs them through expert 0 with zero
  input and drops the result; the real rows' results are the same).
* ``"local"`` on experts cut over ``data`` (the engine's and the
  launcher's path under ``data`` > 1, which the reference runs as
  ``moe_local`` under GSPMD): ``moe_ep``'s dispatch with a capacity of
  ``N·k`` a destination, which no destination can overflow, so no pair
  is dropped and the result is ``moe_local``'s function.  The
  all-to-all still sends ``dp·N·k`` rows for at most ``N·k`` real
  pairs; only the real rows reach the grouped product.

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

from repro_torch.kernels import cost, runtime
from repro_torch.sharding import collectives

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


def check_impl(impl: str, mesh=None) -> None:
    """Refuse what the port does not run: an unknown path, or ``"ep"``
    (expert parallelism over an all-to-all) without a mesh."""
    if impl not in IMPLS:
        raise ValueError(f"moe_impl {impl!r}: one of {IMPLS}")
    if impl == "ep" and mesh is None:
        raise ValueError("moe_impl='ep' runs under a mesh (its experts cut "
                         "over the 'data' axis): pass mesh= or register "
                         "one with sharding.context.set_mesh")


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


def _grouped_like(x, w, offs):
    """A fake call under a count: the card's route, its forward unseen
    (bf16: the grouped product, which allocates nothing on fake tensors,
    with its backward's two; f32: the masked loop where autograd records
    the call, else an empty output)."""
    if x.dtype == torch.bfloat16:
        return GroupedMM.apply(x, w, offs)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return grouped_mm_plain(x, w, offs)
    return x.new_empty((x.shape[0], w.shape[2]))


@cost.scope("grouped_mm", cost.grouped_mm_call, grouped_mm_plain,
            _grouped_like, always=True)
def grouped_mm(x, w, offs):
    """x (M, K) rows sorted by group; w (E, K, N); offs (E,) int32 row
    ends, offs[-1] == M.  Returns (M, N) in x's dtype.  Under a count
    (``launch/op_analysis.py``) it counts ``2 M K N`` by formula on
    either route (``kernels/cost.py:grouped_mm``)."""
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


def moe_local(cfg: ModelConfig, p, x, mesh=None):
    """Sort + grouped product path (active FLOPs only). x: (B,T,d).
    Under a mesh that cuts each expert's d_ff over ``model`` (every
    expert held), the grouped FFN runs on this rank's d_ff columns and
    its partial sums are all-reduced over ``model`` in f32, as
    ``moe_ep``'s are."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(B * T, d)
    gates, idx, _ = router_topk(cfg, p, xt)
    flat_e = idx.reshape(-1)                                  # (N*k,)
    order = torch.argsort(flat_e, stable=True)      # jnp.argsort is stable
    xs = xt.index_select(0, order // k)                       # (N*k, d)
    g_tp = layers.model_group(mesh, p["w_gate"], -1)
    if g_tp is not None:
        xs = collectives.copy_to(xs, g_tp)
    ys = grouped_ffn(p, xs, group_offsets(flat_e, E))
    if g_tp is not None:                  # partial sums over d_ff shards
        ys = collectives.reduce_from(ys.float(), g_tp).to(xt.dtype)
    ys = torch.empty_like(ys).index_copy_(0, order, ys)       # unsort
    ys = ys.reshape(-1, k, d).float()
    out = (ys * gates[..., None]).sum(1).to(x.dtype)
    if cfg.shared_expert:
        out = out + layers.mlp_apply(p["shared"], xt, "silu", mesh)
    return out.reshape(B, T, d)


def moe_ep(cfg: ModelConfig, p, x, mesh, capacity=None):
    """Expert-parallel MoE FFN on this rank's shards (the reference's
    ``moe_ep`` body under ``shard_map``).

    x: (B_loc, T, d), this rank's rows (every row when the batch is not
    cut over ``data``: each data rank then routes the same tokens and
    combines only its own send slots, so the round trip stays correct);
    router (d, E) whole; ``w_gate``/``w_up`` (E_loc, d, f_loc) and
    ``w_down`` (E_loc, f_loc, d): experts [r E_loc, (r+1) E_loc) of data
    rank r, each expert's d_ff cut over ``model`` when the spec says so.
    Each destination rank takes at most ``capacity`` pairs from each
    source (default the reference's ``max(8, round(capacity_factor N k /
    dp))``); overflow pairs are dropped, as in the reference.
    ``capacity=N*k`` drops none (:func:`apply`'s ``"local"`` route on
    cut experts)."""
    dp = mesh.size("data")
    g_ep = mesh.group("data")
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = p["w_gate"].shape[0]
    if E_loc * dp != E:
        raise ValueError(f"moe_ep: {E} experts do not split over {dp} "
                         f"'data' ranks ({E_loc} held here)")
    xt = x.reshape(B * T, d)
    N = xt.shape[0]
    gates, idx, _ = router_topk(cfg, p, xt)

    # dispatch: fixed capacity per destination rank
    flat_e = idx.reshape(-1)                                  # (N*k,)
    dest = torch.div(flat_e, E_loc, rounding_mode="floor")    # owner
    cap = capacity if capacity is not None else \
        int(max(8, round(cfg.capacity_factor * N * k / dp)))
    order = torch.argsort(dest, stable=True)
    dest_s = dest[order]
    tok_of = torch.div(order, k, rounding_mode="floor")
    eloc_s = torch.remainder(flat_e, E_loc)[order]
    ar = torch.arange(N * k, device=x.device)
    pos_in_dest = ar - torch.searchsorted(dest_s, dest_s, side="left")
    keep = pos_in_dest < cap                                  # else dropped
    slot = torch.where(keep, dest_s * cap + pos_in_dest, dp * cap)
    send_x = xt.new_zeros((dp * cap + 1, d)).index_copy(
        0, slot, xt.index_select(0, tok_of))[:-1]
    # unused slots: expert E_loc (none), zero input, no source
    send_e = flat_e.new_full((dp * cap + 1,), E_loc).index_copy(0, slot,
                                                                eloc_s)
    send_src = flat_e.new_full((dp * cap + 1,), -1).index_copy(0, slot,
                                                               order)
    recv_x = collectives.all_to_all(send_x.reshape(dp, cap, d), g_ep)
    recv_e = collectives.all_to_all(send_e[:-1].reshape(dp, cap), g_ep)

    # the grouped FFN of this rank's experts over the received slots:
    # the empty ones sort last, past the last offset, and are not computed
    es_all = recv_e.reshape(dp * cap)
    o2 = torch.argsort(es_all, stable=True)
    xs = recv_x.reshape(dp * cap, d).index_select(0, o2)
    g_tp = layers.model_group(mesh, p["w_gate"], -1)
    if g_tp is not None:
        xs = collectives.copy_to(xs, g_tp)
    ys = grouped_ffn(p, xs, group_offsets(es_all, E_loc + 1)[:E_loc])
    ys = torch.empty_like(ys).index_copy(0, o2, ys)           # unsort
    if g_tp is not None:                  # partial sums over d_ff shards
        ys = collectives.reduce_from(ys.float(), g_tp).to(xt.dtype)
    back = collectives.all_to_all(ys.reshape(dp, cap, d), g_ep)

    # combine: back[s, c] answers this rank's send slot (s, c)
    src = send_src[:-1]
    flat_out = torch.zeros((N * k + 1, d), dtype=torch.float32,
                           device=x.device).index_add(
        0, torch.where(src >= 0, src, N * k),
        back.reshape(dp * cap, d).float())[:-1]
    out = (flat_out.reshape(N, k, d) * gates[..., None]).sum(1).to(x.dtype)
    if cfg.shared_expert:
        shared = layers.mlp_apply(p["shared"], xt, "silu", mesh,
                                  reduce=False)
        g_sh = layers.model_group(mesh, p["shared"]["up"], -1)
        if g_sh is not None:
            shared = collectives.reduce_from(shared.float(), g_sh)
        out = out + shared.to(x.dtype)
    return out.reshape(B, T, d)


def _experts_cut(p, mesh) -> bool:
    """Whether this rank holds a part of the experts only (their expert
    axis cut over a mesh axis of more than one rank)."""
    a = layers.axis(p["w_gate"], 0)
    return mesh is not None and a is not None and mesh.size(a) > 1


def _any_cut(p, mesh) -> bool:
    """Whether any dim of the experts' leaves is cut over a mesh axis of
    more than one rank."""
    return mesh is not None and any(
        mesh.size(a) > 1 for a in (layers.axis(p[n], dim)
                                   for n in ("w_gate", "w_up", "w_down")
                                   for dim in range(3)) if a is not None)


def apply(cfg: ModelConfig, p, x, impl: str = "local", mesh=None):
    """The MoE FFN by ``impl`` (the reference's ``_apply_moe``).  Experts
    cut over ``data`` run ``"ep"``, or ``"local"`` through ``moe_ep``'s
    dispatch at a capacity that drops nothing (``N·k``: ``moe_local``'s
    function, as GSPMD runs the reference's ``moe_local`` on cut
    experts); experts whole with their d_ff cut over ``model`` run
    ``"local"`` tensor-parallel.  The dense oracle ``"ref"`` needs them
    whole."""
    check_impl(impl, mesh)
    if impl == "ep":
        return moe_ep(cfg, p, x, mesh)
    if impl == "ref" and _any_cut(p, mesh):
        raise ValueError("moe_impl='ref' needs every expert whole; under "
                         "a mesh that cuts them use 'local' or 'ep'")
    if _experts_cut(p, mesh):
        B, T, _ = x.shape
        return moe_ep(cfg, p, x, mesh, capacity=B * T * cfg.top_k)
    if impl == "ref":
        return moe_dense_ref(cfg, p, x)
    return moe_local(cfg, p, x, mesh)
