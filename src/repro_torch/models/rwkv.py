"""RWKV6 ("Finch") block: attention-free, with a data-dependent decay.

PyTorch counterpart of ``repro/models/rwkv.py``.  Per head, with the
state ``S`` of shape (hs, hs):

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

The reference's ``wkv_scan`` is ``ops.wkv6`` here: the plain PyTorch
loop for tensors on the CPU, the hand-written CUDA kernel
(``csrc/wkv6.cu``) for tensors on the card.  Prefill, chunked prefill and decode all run it.

Under a mesh (``sharding/partition.py``) the block runs
tensor-parallel over ``model`` with the reference's specs: ``wr``,
``wk``, ``wv``, ``wg``, ``cr`` and ``ck`` column-parallel, ``wo`` and
``cv`` row-parallel (then an f32 all-reduce), the decay LoRA, ``u``,
``w0``, ``ln_x`` and the mix vectors whole.  Where the heads divide over
``model`` each rank runs the recurrence on its own heads (its columns of
``r, k, v, w`` and its heads of the carry ``s``); where only the width
divides, the cut projections are all-gathered and every rank runs every
head.  The token-shift carries ``x_tm`` / ``x_cm`` are cut over the
width: the shift reads them whole (all-gathered over ``model``), and
each rank keeps its columns of the new one.  The channel-mix gate
``sigmoid(xr @ cr)`` is gathered to multiply the row-parallel output.

Dtypes: the decay path (``w0``, ``wA``, ``wB``), the bonus ``u`` and the
state ``s`` are float32 whatever the model's dtype, as in the reference;
:class:`RwkvParams` refuses a cast that would change them.  The token
shift carries ``x_tm`` / ``x_cm``: the *normed* block input of the last
valid token, in the model's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.sharding import collectives

from . import layers
from .config import ModelConfig

F32_LEAVES = ("w0", "wA", "wB", "u")       # parameters
STATE_LEAVES = ("s", "x_tm", "x_cm")      # one block's carry
F32_STATE_LEAVES = ("s",)


def rwkv_n_heads(cfg: ModelConfig) -> int:
    assert cfg.d_model % cfg.rwkv_head_size == 0
    return cfg.d_model // cfg.rwkv_head_size


def channel_mix_width(cfg: ModelConfig) -> int:
    return int(3.5 * cfg.d_model)          # v6 uses 3.5 x d_model


class RwkvParams(layers.KeepsF32):
    """Time-mix and channel-mix weights of one block, with the
    reference's names and shapes (``rwkv_init``)."""

    FAMILY = "RWKV"
    F32_LEAVES = F32_LEAVES

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, r = cfg.d_model, cfg.rwkv_lora_decay
        H, hs, dcm = rwkv_n_heads(cfg), cfg.rwkv_head_size, \
            channel_mix_width(cfg)
        e = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        P = layers.frozen_param
        for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w",
                     "cmix_r", "cmix_k"):
            setattr(self, name, P(torch.full((d,), 0.5, **e)))
        for name in ("wr", "wk", "wv", "wg", "wo", "cr"):
            setattr(self, name, P(torch.empty(d, d, **e)))
        self.w0 = P(torch.full((d,), -0.5, **f32))
        self.wA = P(torch.empty(d, r, **f32))
        self.wB = P(torch.empty(r, d, **f32))
        self.u = P(torch.empty(H, hs, **f32))
        self.ln_x = P(torch.zeros(d, **e))
        self.ck = P(torch.empty(d, dcm, **e))
        self.cv = P(torch.empty(dcm, d, **e))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Random weights with the reference's scales: dense layers
        normal times ``fan_in ** -0.5``, ``wB`` times 0.01, ``u`` times
        0.1."""
        for w in (self.wr, self.wk, self.wv, self.wg, self.wo, self.wA,
                  self.cr, self.ck, self.cv):
            w.copy_(layers.dense_init(gen, w.shape[0], w.shape[1], w.dtype))
        self.wB.copy_(layers.dense_init(gen, *self.wB.shape, torch.float32,
                                        scale=0.01))
        self.u.copy_(layers.dense_init(gen, *self.u.shape, torch.float32,
                                       scale=0.1))


def _shift(x, x_prev):
    """Token shift: prepend x_prev, drop the last. x: (B,T,d); x_prev:
    (B,d)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _group_norm(y, scale, eps: float = 1e-5):
    """Per-head LayerNorm of the wkv output. y: (B,T,H,hs) f32."""
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    yn = (y - mu) * torch.rsqrt(var + eps)
    B, T = y.shape[:2]
    return yn.reshape(B, T, -1) * (1.0 + scale.float())


def _last_valid(x, lengths):
    """x: (B,T,d) -> (B,d) at index lengths-1 (x[:, -1] without
    lengths)."""
    if lengths is None:
        return x[:, -1]
    idx = (lengths.long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _carry_in(x_prev, cut: bool, mesh):
    """A token-shift carry whole (it is kept cut over the width)."""
    return collectives.all_gather(x_prev, mesh.group("model"), -1) \
        if cut else x_prev


def _carry_out(x_last, cut: bool, mesh):
    """This rank's columns of a new token-shift carry."""
    if not cut:
        return x_last
    return x_last.chunk(mesh.size("model"), -1)[
        mesh.coord("model")].contiguous()


def _heads_own(cfg: ModelConfig, p, mesh) -> bool:
    """Whether this rank runs the recurrence on its own heads: the
    time-mix projections are cut over ``model`` and the heads divide."""
    return layers.model_group(mesh, p["wr"], -1) is not None and \
        rwkv_n_heads(cfg) % mesh.size("model") == 0


def time_mix(cfg: ModelConfig, p, x, x_prev, s0, lengths=None, *,
             state_out=None, mesh=None):
    """x: (B,T,d) normed input; x_prev: (B,d) the previous chunk's last
    one; s0: (B,H,hs,hs) f32; sT lands in ``state_out`` when given (it
    may be s0).  Positions at or past ``lengths`` get
    ``k = 0, w = 1``, so the carried state is exactly that of the
    unpadded sequence.  Returns (out, x_last, sT).  Under a mesh
    ``x_prev``, ``s0`` and the returned carries are this rank's cut of
    them (module docstring)."""
    B, T, d = x.shape
    hs = cfg.rwkv_head_size
    cut = layers.model_group(mesh, p["wr"], -1) is not None
    xs = _shift(x, _carry_in(x_prev, cut, mesh))
    xr, xk = _mix(x, xs, p["mix_r"]), _mix(x, xs, p["mix_k"])
    xv, xg = _mix(x, xs, p["mix_v"]), _mix(x, xs, p["mix_g"])
    xw = _mix(x, xs, p["mix_w"])
    r, k, v = (layers.column(xa, p[n], mesh) for xa, n in (
        (xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(layers.column(xg, p["wg"], mesh))
    lora = torch.tanh(xw.float() @ p["wA"])
    if _heads_own(cfg, p, mesh):        # this rank's decay columns
        # lora feeds only this rank's heads here: its gradient is a part
        # of a sum over ``model``
        lora = collectives.copy_to(lora, mesh.group("model"))
        w_hat = layers.own(p["w0"], mesh) + lora @ layers.own(p["wB"], mesh)
        u, ln_x = layers.own(p["u"], mesh, 0), layers.own(p["ln_x"], mesh)
    else:
        w_hat = p["w0"] + lora @ p["wB"]
        r, k, v = (layers.whole(t, p[n], mesh) for t, n in (
            (r, "wr"), (k, "wk"), (v, "wv")))
        u, ln_x = p["u"], p["ln_x"]
    r, k, v = (t.reshape(B, T, -1, hs) for t in (r, k, v))
    w = torch.exp(-torch.exp(w_hat)).reshape(B, T, -1, hs)  # (0,1) decay
    if lengths is not None:
        valid = (torch.arange(T, device=x.device)[None]
                 < lengths[:, None])[..., None, None]
        k = torch.where(valid, k, 0.0)          # no kv injection if padded
        w = torch.where(valid, w, 1.0)          # identity decay if padded
    y, sT = ops.wkv6(r, k, v, w, u, s0, state_out=state_out)
    y = _group_norm(y, ln_x).to(x.dtype)
    if y.shape[-1] != g.shape[-1]:      # every head: this rank's rows of wo
        y = collectives.scatter_to(y, mesh.group("model"), -1)
    out = layers.row(y * g, p["wo"], mesh)
    return out, _carry_out(_last_valid(x, lengths), cut, mesh), sT


def channel_mix(cfg: ModelConfig, p, x, x_prev, lengths=None, mesh=None):
    """Returns (out, x_last); under a mesh ``x_prev`` and ``x_last`` are
    this rank's cut of the carry."""
    cut = layers.model_group(mesh, p["wr"], -1) is not None
    xs = _shift(x, _carry_in(x_prev, cut, mesh))
    xr, xk = _mix(x, xs, p["cmix_r"]), _mix(x, xs, p["cmix_k"])
    r = torch.sigmoid(layers.column(xr, p["cr"], mesh))
    r = layers.whole(r, p["cr"], mesh)
    k = torch.relu(layers.column(xk, p["ck"], mesh))
    return r * layers.row(k * k, p["cv"], mesh), \
        _carry_out(_last_valid(x, lengths), cut, mesh)


def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device="cuda"):
    """Zero carry of one block: ``s`` (B,H,hs,hs) in f32, the token-shift
    inputs ``x_tm`` / ``x_cm`` (B,d) in ``dtype``."""
    device = resolve_device(device)
    H, hs = rwkv_n_heads(cfg), cfg.rwkv_head_size
    shapes = {"s": (batch, H, hs, hs), "x_tm": (batch, cfg.d_model),
              "x_cm": (batch, cfg.d_model)}
    return {name: torch.zeros(shape, device=device, dtype=torch.float32
                              if name in F32_STATE_LEAVES else dtype)
            for name, shape in shapes.items()}
