"""The port's full-sequence ``forward``, the encoder (hubert-xlarge), the
cross-attention VLM (llama-3.2-vision-90b) and nemotron's squared-ReLU
MLP, against the JAX reference with the same weights.

Every one of the reference's 11 archs at its smoke config, f32: the
reference's ``init_params`` weights go through ``repro_torch/bridge.py``
and the same numpy inputs (token ids; an encoder's frame embeddings and a
VLM's vision embeddings, normal times 0.02 as ``data/tokens.py`` makes
them) run through ``repro.models.transformer`` and
``repro_torch.models.transformer``.

The reference inits every cross-attention gate to zero, and tanh(0) = 0:
a cross layer then adds nothing and any port would pass.  So each cross
gate is set to ``0.5 + 0.1 * rep`` in the numpy tree before either
package sees it, and the VLM's forward is checked to move with the gates.

* ``forward`` against ``tfm.forward`` (MoE with ``moe_impl`` ``local``
  and ``ref``) on ragged lengths: the valid rows' logits at atol 1e-4
  (query rows past a row's length are garbage in both packages);
* the twin of ``tests/test_smoke_archs.py::test_prefill_decode_matches_
  forward`` for every arch with a decode step: the port's prefill and 4
  decode steps against the port's ``forward`` and against the JAX
  ``prefill`` / ``decode_step``, logits and the VLM's cross K/V at the
  cache tolerance (atol 2e-5, rtol 2e-4);
* the VLM's paged decode equal to its contiguous decode;
* the encoder's ``prefill(embeds=...)`` against ``forward``;
* the engine's refusals (VLM, encoder) and the launcher's encoder exit.
"""
import copy
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import serve as jserve
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core.engine import TorchEngineBackend
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttfm

LOGIT_TOL = dict(atol=1e-4, rtol=0)
CACHE_TOL = dict(atol=2e-5, rtol=2e-4)
ALL = list_archs()
DECODE = [a for a in ALL if get_config(a).has_decode]
FORWARD_CASES = [(a, "local") for a in ALL] + \
    [(a, "ref") for a in ALL if get_config(a).n_experts]
VLM, ENCODER = "llama-3.2-vision-90b", "hubert-xlarge"

j_forward = jax.jit(jtfm.forward, static_argnums=0,
                    static_argnames=("moe_impl",))
j_prefill = jax.jit(jtfm.prefill, static_argnums=0,
                    static_argnames=("cache_len", "moe_impl"))
j_decode = jax.jit(jtfm.decode_step, static_argnums=0,
                   static_argnames=("moe_impl",))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops: torch's intra-op threads only contend with the
    other test workers.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gates(cfg, tree, base=0.5):
    """Each cross layer's gate set to ``base + 0.1 * rep`` in place."""
    for gi, (pattern, reps) in enumerate(cfg.block_groups()):
        for j, btype in enumerate(pattern):
            if btype == "cross":
                tree["groups"][gi][j]["attn"]["gate"] = np.asarray(
                    base + 0.1 * np.arange(reps), np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference config, port config, reference params, port model)
    with the same weights, the cross gates non-zero."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    tree = jax.tree.map(np.asarray,
                        jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    tree = _gates(jcfg, jax.tree.map(np.array, tree))
    model = bridge.params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), model


def _inputs(cfg, B, T, seed=0):
    """Numpy (tokens or None, extra inputs): an encoder gets frame
    embeddings in place of ids, a VLM vision embeddings beside them."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    kw = {}
    if cfg.arch_type == "audio":
        kw["embeds"] = (rng.standard_normal((B, T, cfg.d_model))
                        * 0.02).astype(np.float32)
        tok = None
    if cfg.arch_type == "vlm":
        kw["vision_embeds"] = (rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_vision)) * 0.02).astype(
                np.float32)
    return tok, kw


def _jax(tok, kw):
    return (None if tok is None else jnp.asarray(tok),
            {k: jnp.asarray(v) for k, v in kw.items()})


def _torch(tok, kw):
    return (None if tok is None else torch.from_numpy(tok),
            {k: torch.from_numpy(v) for k, v in kw.items()})


def _moe_impl(cfg):
    return "ref" if cfg.n_experts else "local"


@pytest.mark.parametrize("arch,moe_impl", FORWARD_CASES)
def test_forward_matches_reference(arch, moe_impl):
    jcfg, tcfg, params, model = _pair(arch)
    B, T = 3, 24
    lens = np.array([24, 17, 9], np.int32)
    tok, kw = _inputs(tcfg, B, T)
    jt, jkw = _jax(tok, kw)
    tt, tkw = _torch(tok, kw)
    want = np.asarray(j_forward(jcfg, params, tokens=jt,
                                lengths=jnp.asarray(lens),
                                moe_impl=moe_impl, **jkw))
    got = ttfm.forward(tcfg, model, tokens=tt,
                       lengths=torch.from_numpy(lens), moe_impl=moe_impl,
                       **tkw)
    assert got.dtype == torch.float32 and got.shape == (B, T,
                                                        tcfg.vocab_size)
    got = got.numpy()
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got[b, :L], want[b, :L], **LOGIT_TOL)
    if tcfg.arch_type == "vlm":
        ungated = copy.deepcopy(model)
        for _, _, _, blk in ungated.blocks():
            if hasattr(blk.attn, "gate"):
                blk.attn.gate.zero_()
        plain = ttfm.forward(tcfg, ungated, tokens=tt, **tkw).numpy()
        assert np.abs(plain - got).max() > 1e-2, "the cross gates add nothing"


@pytest.mark.parametrize("arch", DECODE)
def test_prefill_decode_matches_forward_and_reference(arch):
    """The port's prefill of 16 prompt tokens (lengths 16 and 12) and 4
    decode steps against the port's ``forward`` over all 24 tokens at
    each row's position, and against the JAX prefill and decode steps;
    for the VLM also its cross K/V leaves."""
    jcfg, tcfg, params, model = _pair(arch)
    B, S = 2, 24
    lens = np.array([16, 12], np.int32)
    tok, kw = _inputs(tcfg, B, S)
    mi = _moe_impl(tcfg)
    jt, jkw = _jax(tok, kw)
    tt, tkw = _torch(tok, kw)
    full = ttfm.forward(tcfg, model, tokens=tt, moe_impl=mi, **tkw).numpy()
    jl, jc = j_prefill(jcfg, params, tokens=jt[:, :16],
                       lengths=jnp.asarray(lens), cache_len=S + 4,
                       moe_impl=mi, **jkw)
    tl, tc = ttfm.prefill(tcfg, model, tt[:, :16], torch.from_numpy(lens),
                          cache_len=S + 4, moe_impl=mi, **tkw)
    for gi, (pattern, _) in enumerate(tcfg.block_groups()):
        for j, btype in enumerate(pattern):
            if btype == "cross":
                for key in ("k", "v"):
                    np.testing.assert_allclose(
                        tc["groups"][gi][j][key].numpy(),
                        np.asarray(jc["groups"][gi][j][key]), **CACHE_TOL)
    pos = lens.copy()
    for step in range(5):
        if step:
            nxt = tok[np.arange(B), pos]
            jl, jc = j_decode(jcfg, params, jnp.asarray(nxt), jc,
                              moe_impl=mi)
            tl, tc = ttfm.decode_step(tcfg, model, torch.from_numpy(nxt),
                                      tc, moe_impl=mi)
            pos += 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **CACHE_TOL)
        np.testing.assert_allclose(tl.numpy(), full[np.arange(B), pos - 1],
                                   **CACHE_TOL)
    assert tc["pos"].tolist() == pos.tolist()


def _to_paged(cfg, cache, page):
    """A contiguous cache in a paged pool: each row's pages in a shuffled
    order, a trash page last; per-slot leaves (cross K/V) as they are."""
    B = cache["pos"].shape[0]
    S = next(s["k"].shape[2] for (pat, _), g in
             zip(cfg.block_groups(), cache["groups"])
             for b, s in zip(pat, g) if b == "attn")
    n_p = S // page
    order = torch.from_numpy(np.random.default_rng(1).permutation(B * n_p))
    paged = ttfm.init_paged_cache(cfg, B, S, B * n_p + 1, page,
                                  device="cpu")
    paged["pos"] = cache["pos"].clone()
    paged["block_tables"] = order.reshape(B, n_p).to(torch.int32)
    for (pat, _), src_g, dst_g in zip(cfg.block_groups(), cache["groups"],
                                      paged["groups"]):
        for btype, src_s, dst_s in zip(pat, src_g, dst_g):
            for key, src in src_s.items():
                if btype != "attn":
                    dst_s[key].copy_(src)
                    continue
                dst_s[key][:, order] = src.reshape(
                    (src.shape[0], B * n_p, page) + src.shape[3:])
    return paged


def test_vlm_paged_decode_equals_contiguous():
    """The VLM's self-attention K/V on a shuffled page pool, its cross
    K/V per slot: 6 greedy steps give the contiguous cache's logits."""
    _, tcfg, _, model = _pair(VLM)
    B, S, page = 2, 32, 8
    lens = torch.tensor([20, 7], dtype=torch.int32)
    tok, kw = _torch(*_inputs(tcfg, B, 20, seed=2))
    logits, cont = ttfm.prefill(tcfg, model, tok, lens, cache_len=S, **kw)
    paged = _to_paged(tcfg, cont, page)
    nxt = logits.argmax(-1).to(torch.int32)
    for _ in range(6):
        lc, cont = ttfm.decode_step(tcfg, model, nxt, cont)
        lp, paged = ttfm.decode_step(tcfg, model, nxt, paged,
                                     page_size=page)
        np.testing.assert_allclose(lp.numpy(), lc.numpy(), **CACHE_TOL)
        nxt = lc.argmax(-1).to(torch.int32)


def test_encoder_prefill_matches_forward():
    """hubert-xlarge's ``prefill(embeds=...)`` on ragged lengths: its
    last-token logits are ``forward``'s at each row's last position, and
    its bidirectional attention sees keys after the query (the first
    position's logits move when a later frame does)."""
    _, tcfg, _, model = _pair(ENCODER)
    B, T = 3, 20
    lens = torch.tensor([20, 13, 5], dtype=torch.int32)
    _, kw = _torch(*_inputs(tcfg, B, T, seed=3))
    full = ttfm.forward(tcfg, model, lengths=lens, **kw)
    last, cache = ttfm.prefill(tcfg, model, lengths=lens, cache_len=T, **kw)
    np.testing.assert_allclose(
        last.numpy(), full[torch.arange(B), lens.long() - 1].numpy(),
        **CACHE_TOL)
    assert cache["pos"].tolist() == lens.tolist()
    moved = kw["embeds"].clone()
    moved[:, 3] += 0.05
    later = ttfm.forward(tcfg, model, embeds=moved, lengths=lens)
    assert (later[:, 0] - full[:, 0]).abs().max() > 1e-4


def test_bridge_carries_the_vlm_leaves_and_checks_their_shapes():
    """``vis_proj`` and each cross layer's gate (stacked ``(reps,)``, a
    0-d leaf a block) land in the port; a gate of another shape or a
    missing ``vis_proj`` is refused; nemotron's MLP has no gate."""
    jcfg, tcfg, params, model = _pair(VLM)
    tree = jax.tree.map(np.array, params)
    assert np.array_equal(model.vis_proj.numpy(), tree["vis_proj"])
    gates = [float(blk.attn.gate) for _, j, _, blk in model.blocks()
             if j == tcfg.cross_attn_every - 1]
    np.testing.assert_allclose(gates, [0.5], rtol=1e-6)
    bad = copy.deepcopy(tree)
    bad["groups"][0][1]["attn"]["gate"] = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(bad, tcfg, device="cpu")
    del tree["vis_proj"]
    with pytest.raises(ValueError, match="vis_proj"):
        bridge.params_from_numpy(tree, tcfg, device="cpu")
    nemo = _pair("nemotron-4-340b")[3]
    assert not hasattr(nemo.groups[0][0][0].mlp, "gate")


@pytest.mark.parametrize("arch,reason", [
    (VLM, "prefills token ids only"), (ENCODER, "is encoder-only")])
def test_engine_refuses_what_the_reference_engine_cannot_serve(arch,
                                                               reason):
    _, tcfg, _, model = _pair(arch)
    with pytest.raises(ValueError, match=reason):
        TorchEngineBackend(tcfg, model, device="cpu")


def test_launchers_exit_on_the_encoder_with_the_same_message(monkeypatch):
    """Both launchers exit on the encoder before serving, with the
    reference's words (the port on either backend); the port's
    ``--backend torch`` refuses the VLM before building a model."""
    flags = ["--backend", "sim", "--smoke", "--arch", ENCODER]
    monkeypatch.setattr("sys.argv", ["serve.py"] + flags)
    with pytest.raises(SystemExit) as ref:
        jserve.main()
    msg = ("hubert-xlarge is encoder-only; serve prefill-only workloads via "
           "max_new_tokens=1")
    assert str(ref.value) == msg
    for backend in (["--backend", "sim"], ["--device", "cpu"]):
        with pytest.raises(SystemExit) as port:
            tserve.main(backend + ["--smoke", "--arch", ENCODER])
        assert str(port.value) == msg
    with pytest.raises(SystemExit, match=re.escape(
            "prefills token ids only")):
        tserve.main(["--smoke", "--device", "cpu", "--arch", VLM])
