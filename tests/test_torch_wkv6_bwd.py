"""The gradient of the RWKV6 recurrence on the CPU: ``ref.wkv6_bwd_ref``
(the plain version of the backward kernel ``csrc/wkv6_bwd.cu``) and the
CPU's route of ``wkv6`` under autograd.

* ``wkv6_bwd_ref`` against ``jax.vjp`` of the reference's ``wkv_scan``
  (``repro/models/rwkv.py``) on the same numpy inputs: head sizes 16, 32
  and 64, T 1, 7 and 33, weak and strong decay, s0 != 0, dsT given and
  None, f32 and bf16 r/k/v.  Each gradient is held to a tolerance
  relative to its largest magnitude: 2e-5 in f32 (two f32 summation
  orders over at most 33 steps), and one bf16 rounding, 8e-3, for the
  bf16 dr, dk and dv;
* against torch autograd through ``ref.wkv6_ref`` at f64 (1e-12 of the
  largest magnitude);
* T = 0 and an absent dy;
* ``KernelFunction`` with the backward entry: its gradients equal
  autograd's through the plain version, ``gradcheck`` at f64, an unused
  output's gradient passed as None; and the CPU's recorded ``wkv6``
  going through it;
* the C constant the wrapper mirrors (the checkpoint interval).

The kernel itself against ``wkv6_bwd_ref`` on the card:
``tests/test_torch_kernels.py -k "cuda and wkv6_bwd"``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv import wkv_scan
from repro_torch.kernels import ops, ref, runtime
from repro_torch.kernels import wkv6 as wkv6_kernel
from repro_torch.kernels.autograd import KernelFunction

# constant decays at both ends (tests/test_torch_kernels.py: WKV_DECAYS)
DECAYS = {"strong": float(np.exp(-np.exp(3.0))),
          "weak": float(np.exp(-np.exp(-6.0)))}
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _inputs(shape, dtype, seed=5, decay=None):
    """r, k, v (rounded to ``dtype``), w (sigmoid(normal) or ``decay``),
    u, s0 (nonzero), dy and dsT, as numpy f32."""
    B, T, H, hs = shape
    rng = np.random.default_rng(seed)

    def normal(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    r, k, v = (torch.from_numpy(normal(B, T, H, hs)).to(
        getattr(torch, dtype)).float().numpy() for _ in range(3))
    w = (np.full((B, T, H, hs), decay, np.float32) if decay is not None
         else (1.0 / (1.0 + np.exp(-normal(B, T, H, hs)))).astype(
             np.float32))
    u, s0 = normal(H, hs, scale=0.1), normal(B, H, hs, hs, scale=0.1)
    return r, k, v, w, u, s0, normal(B, T, H, hs), normal(B, H, hs, hs)


def _close_to_max(got, want, rel, name):
    """|got - want| <= rel * max |want| (+ 1e-30 for all-zero gradients)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale + 1e-30, (name, err, scale)


CASES = [((2, 1, 2, 16), "float32", True, None),
         ((2, 7, 3, 32), "float32", False, None),
         ((1, 33, 2, 64), "float32", True, None),
         ((2, 7, 2, 64), "bfloat16", True, None),
         ((1, 33, 2, 32), "bfloat16", False, None),
         ((2, 33, 1, 16), "bfloat16", True, None)] + \
    [((2, 33, 2, 64), dtype, with_dsT, decay)
     for decay in DECAYS for dtype in ("float32", "bfloat16")
     for with_dsT in (True, False)]


@pytest.mark.parametrize("shape,dtype,with_dsT,decay", CASES)
def test_wkv6_bwd_ref_matches_jax_vjp(shape, dtype, with_dsT, decay):
    """The closed-form reverse recurrence against ``jax.vjp`` of the
    reference's ``wkv_scan``: all six gradients, in their inputs'
    dtypes."""
    r, k, v, w, u, s0, dy, dsT = _inputs(shape, dtype,
                                         decay=DECAYS.get(decay))
    jd = getattr(jnp, dtype)
    jargs = [jnp.asarray(x).astype(jd) for x in (r, k, v)] + \
        [jnp.asarray(x) for x in (w, u, s0)]
    _, vjp = jax.vjp(wkv_scan, *jargs)
    want = vjp((jnp.asarray(dy), jnp.asarray(dsT) if with_dsT
                else jnp.zeros(s0.shape, jnp.float32)))
    td = getattr(torch, dtype)
    targs = [torch.from_numpy(x).to(td) for x in (r, k, v)] + \
        [torch.from_numpy(x) for x in (w, u, s0)]
    got = ref.wkv6_bwd_ref(*targs, torch.from_numpy(dy),
                           torch.from_numpy(dsT) if with_dsT else None)
    for name, g, wn in zip(NAMES, got, want):
        assert g.dtype == (td if name in ("dr", "dk", "dv")
                           else torch.float32), name
        rel = 8e-3 if dtype == "bfloat16" and name in ("dr", "dk", "dv") \
            else 2e-5
        _close_to_max(g.float().numpy(), np.asarray(wn, np.float32), rel,
                      name)


def _f64_args(shape, seed=3):
    r, k, v, w, u, s0, dy, dsT = _inputs(shape, "float32", seed=seed)
    return [torch.from_numpy(x).double() for x in (r, k, v, w, u, s0)], \
        torch.from_numpy(dy).double(), torch.from_numpy(dsT).double()


@pytest.mark.parametrize("shape", [(2, 9, 3, 16), (1, 20, 2, 32)])
@pytest.mark.parametrize("with_dsT", [True, False])
def test_wkv6_bwd_ref_matches_autograd_at_f64(shape, with_dsT):
    """In f64 the closed form equals autograd through ``wkv6_ref`` to
    rounding."""
    args, dy, dsT = _f64_args(shape)
    args = [a.requires_grad_(True) for a in args]
    y, sT = ref.wkv6_ref(*args)
    outs, cots = ((y, sT), (dy, dsT)) if with_dsT else ((y,), (dy,))
    want = torch.autograd.grad(outs, args, cots)
    got = ref.wkv6_bwd_ref(*(a.detach() for a in args), dy,
                           dsT if with_dsT else None)
    for name, g, wn in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        _close_to_max(g.numpy(), wn.numpy(), 1e-12, name)


def test_wkv6_bwd_ref_takes_an_empty_sequence_and_no_dy():
    """T = 0: empty step gradients, du = 0 and ds0 = dsT (0 without it);
    dy None is a zero dy: only dsT flows back."""
    r, k, v, w, u, s0, dy, dsT = (torch.from_numpy(x) for x in
                                  _inputs((2, 0, 3, 16), "float32"))
    dr, dk, dv, dw, du, ds0 = ref.wkv6_bwd_ref(r, k, v, w, u, s0, dy, dsT)
    assert dr.shape == dk.shape == dv.shape == dw.shape == (2, 0, 3, 16)
    assert torch.equal(du, torch.zeros(3, 16)) and torch.equal(ds0, dsT)
    assert torch.equal(ref.wkv6_bwd_ref(r, k, v, w, u, s0, dy)[5],
                       torch.zeros_like(s0))
    args, _, dsT = _f64_args((1, 6, 2, 16))
    args = [a.requires_grad_(True) for a in args]
    _, sT = ref.wkv6_ref(*args)
    want = torch.autograd.grad(sT, args, dsT, allow_unused=True)
    got = ref.wkv6_bwd_ref(*(a.detach() for a in args), None, dsT)
    for name, g, wn, a in zip(NAMES, got, want, args):
        wn = torch.zeros_like(a) if wn is None else wn   # r, u: unused
        _close_to_max(g.numpy(), wn.detach().numpy(), 1e-12, name)


def _grad_inputs(dtype, B=2, T=6, H=2, hs=4):
    gen = torch.Generator().manual_seed(9)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64)
                * scale).to(dtype).requires_grad_(True)
    w = torch.sigmoid(torch.randn((B, T, H, hs), generator=gen,
                                  dtype=torch.float64)).to(
        dtype).requires_grad_(True)
    return (rnd(B, T, H, hs), rnd(B, T, H, hs), rnd(B, T, H, hs), w,
            rnd(H, hs, scale=0.1), rnd(B, H, hs, hs, scale=0.1))


def test_kernel_function_with_a_backward_entry():
    """A ``KernelFunction`` of the plain forward and ``wkv6_bwd_ref`` as
    its backward entry: its gradients are autograd's through the plain
    version (f32, both outputs used, then sT unused), it counts no
    plain backward pass, and ``gradcheck`` holds it at f64."""
    fn = KernelFunction("test_wkv6", ref.wkv6_ref,
                        backward=ref.wkv6_bwd_ref)
    args = _grad_inputs(torch.float32)
    gen = torch.Generator().manual_seed(2)
    runtime.reset_launch_counts()
    y, sT = fn(*args)
    cots = [torch.randn(t.shape, generator=gen) for t in (y, sT)]
    got = torch.autograd.grad((y, sT), args, cots)
    py, psT = ref.wkv6_ref(*args)
    want = torch.autograd.grad((py, psT), args, cots)
    for g, wn in zip(got, want):
        torch.testing.assert_close(g, wn, rtol=1e-5, atol=1e-6)
    got = torch.autograd.grad(fn(*args)[0].sum(), args)     # sT unused
    want = torch.autograd.grad(ref.wkv6_ref(*args)[0].sum(), args)
    for g, wn in zip(got, want):
        torch.testing.assert_close(g, wn, rtol=1e-5, atol=1e-6)
    assert all(n == 0 for n in runtime.autograd_counts.values())
    assert torch.autograd.gradcheck(fn, _grad_inputs(torch.float64))


@pytest.mark.parametrize("gradient", ["both", "neither"])
def test_kernel_function_takes_one_gradient(gradient):
    """A ``KernelFunction`` has a plain version or a backward entry: with
    both, one would never run; with neither, it has no gradient."""
    given = dict(both=(ref.wkv6_ref, ref.wkv6_bwd_ref),
                 neither=(None, None))[gradient]
    with pytest.raises(ValueError, match="not both or neither"):
        KernelFunction("test_wkv6", ref.wkv6_ref, given[0],
                       backward=given[1])


def test_cpu_wkv6_under_autograd_takes_the_backward_entry(monkeypatch):
    """On the CPU a recorded ``ops.wkv6`` runs the plain forward with the
    backward entry ``ops.wkv6_bwd`` (the plain backward here), once, and
    only the inputs that need a gradient get one; ``state_out`` is
    refused under autograd, as on the card."""
    seen = []
    entry = ops._WKV6_GRAD.backward

    def spy(*a):
        seen.append(len(a))
        return entry(*a)
    monkeypatch.setattr(ops._WKV6_GRAD, "backward", spy)
    r, k, v, w, u, s0 = _grad_inputs(torch.float32)
    u.requires_grad_(False)
    y, _ = ops.wkv6(r, k, v, w, u, s0)
    assert type(y.grad_fn).__name__ == "_ApplyBackward"
    got = torch.autograd.grad(y.sum(), (r, k, v, w, s0))
    assert seen == [8]                  # six inputs, dy, dsT (None)
    want = torch.autograd.grad(ref.wkv6_ref(r, k, v, w, u, s0)[0].sum(),
                               (r, k, v, w, s0))
    for g, wn in zip(got, want):
        torch.testing.assert_close(g, wn, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="state_out"):
        ops.wkv6(r, k, v, w, u, s0, state_out=s0.detach().clone())


def test_wkv6_bwd_constant_matches_source():
    """The wrapper's checkpoint interval (its workspace size) is the
    kernel's."""
    src = (Path(ref.__file__).parent.parent / "csrc" /
           "wkv6_bwd.cu").read_text()
    chunk = int(re.search(r"constexpr int kBwdChunk = (\d+);", src)[1])
    assert chunk == wkv6_kernel.BWD_CHUNK
    assert "wkv6_bwd.cu" in runtime.SOURCES and "wkv6_bwd" in runtime.KERNELS
