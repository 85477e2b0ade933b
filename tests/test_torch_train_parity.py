"""The port's training slice against the JAX reference with the same
weights: the LM loss and every gradient leaf, one AdamW step, remat.

Seven smoke configs at f32 (qwen3-14b, rwkv6-3b, recurrentgemma-2b,
qwen3-moe-235b-a22b, hubert-xlarge, llama-3.2-vision-90b,
nemotron-4-340b): the reference's ``init_params(cfg, PRNGKey(0))``
weights go through ``bridge.params_from_numpy``, the same numpy batch
(``data/tokens.py``'s draws in both packages) goes through
``repro.train.train_loop.lm_loss`` under ``jax.value_and_grad`` and
through the port's ``lm_loss`` and ``backward``.  Before either package
sees the weights, every norm scale (zero at init) is set to a seeded
``0.1 * normal`` and the VLM's cross gates to ``0.5 + 0.1 * rep``: a
zero norm scale hides the stacked-rank decay rule of AdamW (the
reference decays a block's norm, stacked ``(reps, d)``; the port holds it
1-D), and a zero gate hides the cross layers (tanh(0) = 0).

Tolerances: the loss within rtol 1e-5; each gradient leaf within
``1e-4 x max |g|`` of that leaf; the AdamW step's parameters and moments
within f32 rounding of the reference's (atol 1e-6 of the update scale).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import tokens as jtokens
from repro.models import transformer as jtfm
from repro.train import optimizer as joptim
from repro.train import train_loop as jloop
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.data import tokens as ttokens
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_loop as tloop

ARCHS = ["qwen3-14b", "rwkv6-3b", "recurrentgemma-2b",
         "qwen3-moe-235b-a22b", "hubert-xlarge", "llama-3.2-vision-90b",
         "nemotron-4-340b"]
NORMS = ("ln1", "ln2", "ln_f", "q_norm", "k_norm", "ln_x")
B, T = 2, 17


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops: torch's intra-op threads only contend with the
    other test workers.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _set_leaves(tree, rng, path=()):
    """Norm scales to ``0.1 * normal`` and cross gates to ``0.5 + 0.1 *
    rep``, in place in a numpy tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            _set_leaves(v, rng, path + (k,))
        elif k in NORMS:
            tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        elif k == "gate" and path[-1] == "attn":
            tree[k] = (0.5 + 0.1 * np.arange(v.shape[0])).astype(v.dtype)


def _mutable(tree):
    if isinstance(tree, dict):
        return {k: _mutable(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_mutable(v) for v in tree]
    return np.array(tree)


def _frozen(tree):
    if isinstance(tree, dict):
        return {k: _frozen(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return tuple(_frozen(v) for v in tree)
    return tree


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's numpy weights with norms and gates set."""
    jcfg = jax_smoke_config(arch)
    tree = _mutable(jax.tree.map(np.asarray, jtfm.init_params(
        jcfg, jax.random.PRNGKey(0))))
    _set_leaves(tree, np.random.default_rng(7))
    return _frozen(tree)


def _pair(arch):
    """(reference config, port config, reference params, fresh port model
    holding the same weights)."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    tree = _weights(arch)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, tcfg, device="cpu"))


def _batches(jcfg, tcfg):
    """The same first batch from both packages' ``batches``, and a
    ``loss_mask`` for the token archs (its first column and one row's
    tail masked)."""
    jb = next(jtokens.batches(jcfg, B, T))
    tb = next(ttokens.batches(tcfg, B, T, device="cpu"))
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
    if not jcfg.is_encoder:
        mask = np.ones((B, T), np.float32)
        mask[1, T - 5:] = 0
        jb["loss_mask"] = jnp.asarray(mask)
        tb["loss_mask"] = torch.from_numpy(mask)
    return jb, tb


def _grads(model):
    """Each leaf's gradient as the reference's numpy leaf; a parameter
    the loss never reached (an encoder's embedding) has zeros, as JAX
    gives it."""
    def grad(p):
        return torch.zeros_like(p) if p.grad is None else p.grad
    return {k: bridge.stack([grad(p) for p in v] if isinstance(v, list)
                            else grad(v))
            for k, v in bridge.leaves(model).items()}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    jcfg, tcfg, jparams, _ = _pair(arch)
    jb, _ = _batches(jcfg, tcfg)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jloop.lm_loss(jcfg, p, jb, "local"), has_aux=True))(
            jparams)
    return float(loss), float(aux["tokens"]), bridge.flatten(
        jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch):
    jcfg, tcfg, _, model = _pair(arch)
    _, tb = _batches(jcfg, tcfg)
    want_loss, want_tokens, want = _jax_loss_and_grads(arch)
    model.requires_grad_(True)
    loss, aux = tloop.lm_loss(tcfg, model, tb, "local")
    loss.backward()
    assert float(aux["tokens"]) == want_tokens
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    got = _grads(model)
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        w = want[key]
        assert g.shape == w.shape, key
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * scale + 1e-12, (key, err, scale)


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-3b"])
def test_adamw_step_matches_the_reference(arch):
    """One ``optimizer.apply`` from the same gradients: every parameter
    and moment, with the norms non-zero so the decay rule's stacked rank
    shows (the reference decays a block's norm scale)."""
    jcfg, tcfg, jparams, model = _pair(arch)
    _, _, grads = _jax_loss_and_grads(arch)
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.5)
    jp, jstate, jm = joptim.apply(
        joptim.AdamWConfig(**opt), jparams,
        jax.tree.map(jnp.asarray, bridge.unflatten(grads)),
        joptim.init(jparams))
    params = bridge.leaves(model)
    tgrads = {k: [torch.from_numpy(a) for a in grads[k]]
              if isinstance(v, list) else torch.from_numpy(grads[k])
              for k, v in params.items()}
    state = toptim.init(params)
    _, state, tm = toptim.apply(toptim.AdamWConfig(**opt), params, tgrads,
                                state)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert float(tm["lr"]) == float(jm["lr"])
    assert int(state["step"]) == int(jstate["step"]) == 1
    want = bridge.flatten(jax.tree.map(np.asarray, jp))
    before = bridge.flatten(_weights(arch))
    scale = min(1.0, 1.0 / float(jm["grad_norm"]))
    norms = 0
    for key, leaf in bridge.leaves(model).items():
        got = bridge.stack(leaf)
        np.testing.assert_allclose(got, want[key], rtol=0, atol=1e-6,
                                   err_msg=key)
        for part in ("m", "v"):
            np.testing.assert_allclose(
                bridge.stack(state[part][key]),
                np.asarray(bridge.flatten(jstate[part])[key]), rtol=1e-6,
                atol=1e-12, err_msg=f"{part} {key}")
        if key.startswith("groups/") and key.split("/")[-1] in NORMS:
            # a block's norm scale: 1-D in the port, (reps, d) in the
            # reference, which decays it; the first step's update is
            # lr (g / (|g| + eps) + wd p)
            norms += 1
            assert leaf[0].dim() == 1
            assert bridge.reference_ndim(leaf) == 2
            g = grads[key].astype(np.float64) * scale
            p0 = before[key].astype(np.float64)
            step = g / (np.abs(g) + 1e-8)
            np.testing.assert_allclose(got, p0 - 1e-2 * (step + 0.5 * p0),
                                       rtol=0, atol=1e-6, err_msg=key)
            assert np.abs(got - (p0 - 1e-2 * step)).max() > 1e-4
    assert norms >= 2


def test_remat_equals_no_remat():
    """``forward(remat=True)`` (each repetition under
    ``torch.utils.checkpoint``) gives the loss and gradients of the plain
    forward, for an attention and a recurrent config."""
    for arch in ("qwen3-14b", "recurrentgemma-2b"):
        jcfg, tcfg, _, _ = _pair(arch)
        _, tb = _batches(jcfg, tcfg)
        out = []
        for remat in (False, True):
            model = _pair(arch)[3].requires_grad_(True)
            loss, _ = tloop.lm_loss(tcfg, model, tb, remat=remat)
            loss.backward()
            out.append((float(loss), _grads(model)))
        assert out[0][0] == out[1][0]
        for key, g in out[0][1].items():
            np.testing.assert_allclose(out[1][1][key], g, rtol=1e-6,
                                       atol=1e-9, err_msg=key)
