"""RG-LRU recurrent block (recurrentgemma / Griffin, arXiv:2402.19427).

PyTorch counterpart of ``repro/models/rglru.py``.  Recurrent branch:
x -> W_x -> temporal conv (width 4) -> RG-LRU; gate branch: x -> W_g ->
GeLU; output: (h ⊙ gate) @ W_o.  Per channel:

    r_t = σ(W_r x_t)                      recurrence gate
    i_t = σ(W_i x_t)                      input gate
    log a_t = -c · softplus(Λ) · r_t      (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)

The recurrence is diagonal, so prefill runs it as a parallel scan over
T.  The reference's ``jax.lax.associative_scan`` is XLA code, not a
Pallas kernel; here it is a doubling (Hillis–Steele) scan in plain
torch: ``ceil(log2 T)`` steps, each one elementwise pass over the whole
(B, T, w) pair, never a Python loop over T.  Its float sums are taken in
another order than JAX's tree, so the two agree to rounding (the kernel
tolerance at f32), not bit for bit.  Decode is one step.

Under a mesh (``sharding/partition.py``) the branch runs
tensor-parallel over ``model`` with the reference's specs: ``wx``,
``wg``, ``wr``, ``wi`` and the conv kernel cut over the width
(column-parallel), ``wo`` row-parallel (then an f32 all-reduce).  Each
rank holds its channels of the conv output, of the carries ``h`` and
``conv`` and of the recurrence; the gates' products read the whole conv
output (all-gathered over ``model``) and give this rank's channels, with
its part of ``lam``.

Dtypes: ``wr``, ``wi`` and ``lam`` are float32 whatever the model's
dtype, as ``rglru_init`` makes them (:class:`RecParams` refuses a cast
that would change them); the gates and the carry ``h`` are f32, the conv
kernel and the conv state ``conv`` (the last cw-1 inputs of the conv)
take the model's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.sharding import collectives

from . import layers
from .config import ModelConfig

_C = 8.0
F32_LEAVES = ("wr", "wi", "lam")          # parameters
STATE_LEAVES = ("h", "conv")              # one block's carry
F32_STATE_LEAVES = ("h",)


class RecParams(layers.KeepsF32):
    """The recurrent branch's weights, with the reference's names and
    shapes (``rglru_init``)."""

    FAMILY = "RG-LRU"
    F32_LEAVES = F32_LEAVES

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width
        e = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        P = layers.frozen_param
        self.wx = P(torch.empty(d, w, **e))
        self.wg = P(torch.empty(d, w, **e))
        self.wo = P(torch.empty(w, d, **e))
        self.conv = P(torch.empty(cfg.conv_width, w, **e))
        self.wr = P(torch.empty(w, w, **f32))
        self.wi = P(torch.empty(w, w, **f32))
        self.lam = P(torch.empty(w, **f32))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Random weights with the reference's scales: projections normal
        times ``fan_in ** -0.5``, the conv kernel times ``(cw w) ** -0.5``,
        the gates times ``w ** -0.5``, ``lam`` spread over [0.9, 4]."""
        for wt in (self.wx, self.wg, self.wo):
            wt.copy_(layers.dense_init(gen, *wt.shape, wt.dtype))
        cw, w = self.conv.shape
        self.conv.copy_(layers.dense_init(gen, cw, w, self.conv.dtype,
                                          scale=(cw * w) ** -0.5))
        for wt in (self.wr, self.wi):
            wt.copy_(layers.dense_init(gen, w, w, torch.float32,
                                       scale=w ** -0.5))
        self.lam.copy_(torch.linspace(0.9, 4.0, w, dtype=torch.float32))


def _conv1d(x, kernel, state):
    """Causal temporal conv. x: (B,T,w); kernel: (cw,w); state:
    (B,cw-1,w).  Returns (out, the last cw-1 inputs)."""
    cw = kernel.shape[0]
    xp = torch.cat([state, x], dim=1)
    T = x.shape[1]
    out = xp[:, 0:T] * kernel[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + T] * kernel[i]
    new_state = xp[:, -(cw - 1):] if cw > 1 else state
    return out, new_state


def _rglru_gates(p, x, mesh=None):
    """Returns (a, gated x), both f32 (B,T,w) (this rank's channels of
    both under a mesh that cuts the width)."""
    xf = x.float()
    lam = p["lam"]
    xw = xf
    g = layers.model_group(mesh, p["wr"], -1)
    if g is not None:           # whole input, this rank's gate columns
        xw = collectives.copy_to(collectives.gather_from(xf, g, -1), g)
        lam = layers.own(lam, mesh)
    r = torch.sigmoid(xw @ p["wr"])
    i = torch.sigmoid(xw @ p["wi"])
    # jax.nn.softplus is logaddexp(x, 0)
    sp = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -_C * sp * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * xf)
    return a, gated_x


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t with h_0 = 0, over axis 1, as a doubling
    scan: after the step of span d every position holds the composition
    of the (at most 2d) steps ending at it.  a, b: (B,T,w) f32."""
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], dim=1)
        if 2 * d < T:                  # the last step needs no a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(p, x, h0, lengths=None, mesh=None):
    """x: (B,T,w); h0: (B,w).  Steps at or past ``lengths`` are the
    identity (a = 1, b = 0), so the last h is that of the unpadded
    sequence.  Returns (h (B,T,w), h_last (B,w)), f32."""
    a, b = _rglru_gates(p, x, mesh)
    if lengths is not None:
        valid = (torch.arange(x.shape[1], device=x.device)[None]
                 < lengths[:, None])[..., None]
        a = torch.where(valid, a, 1.0)
        b = torch.where(valid, b, 0.0)
    # fold h0 into the first step: h_1 = a_1 h0 + b_1
    b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                  dim=1)
    h = linear_scan(a, b)
    return h, h[:, -1]


def rglru_step(p, x, h0, mesh=None):
    """One-token update. x: (B,1,w).  Returns (h (B,1,w), h (B,w))."""
    a, b = _rglru_gates(p, x, mesh)
    h = a[:, 0] * h0.float() + b[:, 0]
    return h[:, None], h


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def rec_block_forward(cfg: ModelConfig, p, x, state, lengths=None,
                      mesh=None):
    """x: (B,T,d); state: {"h": (B,w), "conv": (B,cw-1,w)} (this rank's
    channels under a mesh).  Returns (out, new state); the new conv
    state holds the last cw-1 *valid* inputs of each row."""
    gate = _gelu(layers.column(x, p["wg"], mesh))
    xr = layers.column(x, p["wx"], mesh)
    xr_conv, conv_state = _conv1d(xr, p["conv"], state["conv"])
    if lengths is not None:
        cw1 = conv_state.shape[1]
        T = xr.shape[1]
        xp = torch.cat([state["conv"], xr], dim=1)       # (B, cw-1+T, w)
        idx = (lengths.long()[:, None]
               + torch.arange(cw1, device=x.device)[None]).clamp(
                   0, cw1 + T - 1)
        conv_state = torch.gather(
            xp, 1, idx[..., None].expand(-1, -1, xp.shape[-1]))
    h, h_last = rglru_scan(p, xr_conv, state["h"], lengths, mesh)
    out = layers.row(h.to(x.dtype) * gate, p["wo"], mesh)
    return out, {"h": h_last, "conv": conv_state}


def rec_block_decode(cfg: ModelConfig, p, x, state, mesh=None):
    """One token, x: (B,1,d).  ``state``'s leaves are written in place
    (the step keeps its storage, so it can be captured as a CUDA graph).
    Returns (out, state)."""
    gate = _gelu(layers.column(x, p["wg"], mesh))
    xr = layers.column(x, p["wx"], mesh)
    xr, conv_state = _conv1d(xr, p["conv"], state["conv"])
    h, h_last = rglru_step(p, xr, state["h"], mesh)
    out = layers.row(h.to(x.dtype) * gate, p["wo"], mesh)
    state["h"].copy_(h_last)
    state["conv"].copy_(conv_state)
    return out, state


def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device="cuda"):
    """Zero carry of one block: ``h`` (B,w) in f32, ``conv`` (B,cw-1,w)
    in ``dtype``."""
    device = resolve_device(device)
    w = cfg.lru_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}
