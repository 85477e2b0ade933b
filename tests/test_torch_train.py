"""The port's training substrate: AdamW, the LM step on every arch,
checkpoints both ways with the reference, the token stream and the
launcher (the kernels under autograd: ``tests/test_torch_kernels.py``).

* twins of ``tests/test_train.py``'s six tests and of
  ``tests/test_smoke_archs.py::test_train_step_smoke`` for all 11 archs;
* ``schedule`` at warm-up, peak and end against the reference's;
* ``SyntheticLM`` and ``batches`` draws bit-identical to the reference's;
* a checkpoint written by each package restored by the other;
* a frozen model's ``forward`` records no graph;
* the launcher's ``--smoke --device cpu`` run: the loss drops and its
  ``--ckpt`` restores in ``repro.train.checkpoint``;
* the ``train_tiny`` example's twin on the CPU.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import tokens as jtokens
from repro.models import transformer as jtfm
from repro.train import checkpoint as jckpt
from repro.train import optimizer as joptim
from repro_torch import bridge
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.data import tokens as data_tokens
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint, optimizer, train_loop

ALL = list(list_archs())

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops: torch's intra-op threads only contend with the
    other test workers.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------ twins of tests/test_train.py --
class TestOptimizer:
    def test_schedule_warmup_and_decay(self):
        cfg = optimizer.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                                    min_lr_ratio=0.1)
        lrs = [float(optimizer.schedule(cfg, torch.tensor(s)))
               for s in (0, 5, 10, 100)]
        assert lrs[0] == 0.0
        assert lrs[1] == pytest.approx(0.5, abs=0.01)
        assert lrs[2] == pytest.approx(1.0, abs=0.01)
        assert lrs[3] == pytest.approx(0.1, abs=0.01)

    def test_adamw_descends_quadratic(self):
        params = {"w": torch.tensor([3.0, -2.0])}
        cfg = optimizer.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                                    weight_decay=0.0, min_lr_ratio=1.0)
        state = optimizer.init(params)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}             # d/dp p^2
            params, state, _ = optimizer.apply(cfg, params, grads, state)
        assert float(params["w"].abs().max()) < 0.05

    @pytest.mark.parametrize("scale", [0.5, 1.0, 3.7, 25.0, 100.0])
    def test_grad_clip_bounds_update(self, scale):
        params = {"w": torch.ones(4)}
        cfg = optimizer.AdamWConfig(lr=1e-2, grad_clip=1.0, warmup_steps=0,
                                    weight_decay=0.0)
        state = optimizer.init(params)
        grads = {"w": torch.full((4,), scale)}
        _, state, metrics = optimizer.apply(cfg, params, grads, state)
        assert float(metrics["grad_norm"]) == pytest.approx(2 * scale)
        # post-clip effective norm is min(gnorm, clip): m bounded by it
        m = state["m"]["w"]
        assert torch.isfinite(m).all()
        assert float(m.norm()) <= 0.1 * min(2 * scale, 1.0) + 1e-6


def test_loss_decreases_tiny_model():
    cfg = get_smoke_config("stablelm-1.6b", vocab_size=128, d_model=64,
                           n_heads=2, n_kv_heads=2, d_ff=128)
    it = data_tokens.batches(cfg, batch_size=4, seq_len=32, device="cpu")
    _, _, hist = train_loop.train(
        cfg, steps=30, batch_iter=it,
        opt_cfg=optimizer.AdamWConfig(lr=3e-3, warmup_steps=5,
                                      total_steps=30),
        log_every=29, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_smoke_config("yi-6b")
    model = tfm.init_params(cfg, seed=0, device="cpu")
    state = optimizer.init(bridge.leaves(model))
    state["m"]["embed"].normal_()
    state["step"].fill_(7)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, model, state, meta={"step": 7})
    model2 = tfm.init_params(cfg, seed=1, device="cpu")
    state2 = optimizer.init(bridge.leaves(model2))
    _, state2 = checkpoint.restore(path, model2, state2)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    for part in ("m", "v"):
        assert bridge.flatten({k: bridge.stack(v) for k, v in
                               state[part].items()}).keys() == \
            bridge.flatten({k: bridge.stack(v) for k, v in
                            state2[part].items()}).keys()
        for k in state[part]:
            np.testing.assert_array_equal(bridge.stack(state[part][k]),
                                          bridge.stack(state2[part][k]))
    assert int(state2["step"]) == 7


def test_synthetic_lm_is_learnable_structure():
    """The bigram structure must be deterministic given the seed."""
    g1 = data_tokens.SyntheticLM(256, seed=3)
    g2 = data_tokens.SyntheticLM(256, seed=3)
    np.testing.assert_array_equal(g1.sample(2, 16), g2.sample(2, 16))
    assert g1.sample(2, 16).max() < 256


# ----------------------------- twin of test_smoke_archs train step ------
@pytest.mark.parametrize("arch", ALL)
def test_train_step_smoke(arch):
    cfg = get_smoke_config(arch)
    model = tfm.init_params(cfg, seed=0, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    opt_cfg = optimizer.AdamWConfig(lr=1e-3, total_steps=10)
    state = optimizer.init(bridge.leaves(model))
    step = train_loop.make_train_step(cfg, opt_cfg, moe_impl="local")
    batch = next(data_tokens.batches(cfg, batch_size=2, seq_len=32,
                                     device="cpu"))
    model, state, metrics = step(model, state, batch)
    assert torch.isfinite(metrics["loss"])
    assert torch.isfinite(metrics["grad_norm"])
    assert set(metrics) == {"loss", "tokens", "grad_norm", "lr"}
    # params actually changed
    delta = max(float((a - b.detach()).abs().max())
                for a, b in zip(before, model.parameters()))
    assert delta > 0
    assert all(p.grad is None for p in model.parameters())


# --------------------------------------------------- against the reference
def test_schedule_matches_the_reference_at_warmup_peak_and_end():
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=1000,
               min_lr_ratio=0.1)
    tc, jc = optimizer.AdamWConfig(**cfg), joptim.AdamWConfig(**cfg)
    for s in (0, 1, 37, 100, 101, 550, 999, 1000, 1500):
        got = optimizer.schedule(tc, torch.tensor(s, dtype=torch.int32))
        want = joptim.schedule(jc, jnp.asarray(s, jnp.int32))
        assert float(got) == float(want), s


@pytest.mark.parametrize("arch", ["qwen3-14b", "hubert-xlarge",
                                  "llama-3.2-vision-90b"])
def test_batches_are_the_reference_draws(arch):
    """``SyntheticLM`` and ``batches`` draw bit for bit what the
    reference's draw, for a token, an encoder and a VLM config."""
    cfg = get_smoke_config(arch)
    g1, g2 = data_tokens.SyntheticLM(cfg.vocab_size, 5), \
        jtokens.SyntheticLM(cfg.vocab_size, 5)
    np.testing.assert_array_equal(g1.sample(3, 20), g2.sample(3, 20))
    mine = data_tokens.batches(cfg, 2, 16, seed=4, device="cpu")
    theirs = jtokens.batches(jax_smoke_config(arch), 2, 16, seed=4)
    for _ in range(2):
        a, b = next(mine), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == {np.dtype("int32"): torch.int32,
                                  np.dtype("float32"): torch.float32}[
                                      np.asarray(b[k]).dtype]
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-3b",
                                  "llama-3.2-vision-90b",
                                  "llama4-scout-17b-a16e"])
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """``bridge.params_to_numpy`` stacks the per-repetition modules back
    into the reference's tree: the same structure and leaves as the
    reference's ``init_params`` (a VLM's 0-d gates and ``vis_proj``, the
    MoE's experts and shared expert included)."""
    cfg = jax_smoke_config(arch)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        cfg, jax.random.PRNGKey(0)))
    back = bridge.params_to_numpy(bridge.params_from_numpy(
        tree, get_smoke_config(arch), device="cpu"))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def _jax_tree(arch):
    cfg = jax_smoke_config(arch)
    return cfg, jtfm.init_params(cfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ["qwen3-14b", "recurrentgemma-2b"])
def test_checkpoint_written_by_either_package_restores_in_the_other(
        arch, tmp_path):
    """A reference checkpoint (params, AdamW state after one step,
    metadata) restores into the port's model and state, and the port's
    save of those restores in the reference equal to the original."""
    jcfg, jparams = _jax_tree(arch)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), jparams)
    jp, jstate, _ = joptim.apply(joptim.AdamWConfig(), jparams, grads,
                                 joptim.init(jparams))
    jpath = str(tmp_path / "jax.npz")
    jckpt.save(jpath, jp, jstate, meta={"steps": 1})
    model = tfm.init_params(get_smoke_config(arch), seed=3, device="cpu")
    state = optimizer.init(bridge.leaves(model))
    checkpoint.restore(jpath, model, state)
    want_p = bridge.flatten(jax.tree.map(np.asarray, jp))
    for key, leaf in bridge.leaves(model).items():
        np.testing.assert_array_equal(bridge.stack(leaf), want_p[key])
    want_m = bridge.flatten(jax.tree.map(np.asarray, jstate["m"]))
    for key, leaf in state["m"].items():
        np.testing.assert_array_equal(bridge.stack(leaf), want_m[key])
    assert int(state["step"]) == 1
    tpath = str(tmp_path / "torch.npz")
    checkpoint.save(tpath, model, state, meta={"steps": 1})
    p2, o2 = jckpt.restore(tpath, jparams, joptim.init(jparams))
    for a, b in zip(jax.tree.leaves((jp, jstate)), jax.tree.leaves((p2, o2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(tpath) as z, np.load(jpath) as zj:
        assert sorted(z.files) == sorted(zj.files)


def test_frozen_model_forward_records_no_graph():
    cfg = get_smoke_config("qwen3-14b")
    model = tfm.init_params(cfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    toks = torch.randint(0, cfg.vocab_size, (2, 12))
    out = tfm.forward(cfg, model, toks)
    assert not out.requires_grad and out.grad_fn is None
    model.requires_grad_(True)
    out = tfm.forward(cfg, model, toks, remat=True)
    assert out.requires_grad


# ------------------------------------------------------------ launcher --
def test_cpu_train_launcher_drops_the_loss_and_writes_a_checkpoint(
        capsys, tmp_path):
    from repro_torch.launch import train
    path = str(tmp_path / "ck.npz")
    assert train.main(["--smoke", "--device", "cpu", "--steps", "20",
                       "--batch", "4", "--seq", "32", "--ckpt", path]) == 0
    out = capsys.readouterr().out
    assert re.search(r"step    0 loss=\d+\.\d{4} lr=", out), out
    m = re.search(r"20 steps in [\d.]+s \(\d+ tok/s\); loss "
                  r"([\d.]+) -> ([\d.]+)", out)
    assert m and float(m.group(2)) < float(m.group(1)), out
    jcfg, jparams = _jax_tree("qwen3-14b")
    p, o = jckpt.restore(path, jparams, joptim.init(jparams))
    assert int(o["step"]) == 20
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(p))


def test_train_launcher_refuses_a_mesh(capfd):
    """``--data/--model`` train on a mesh: on the CPU the launcher spawns
    gloo ranks itself (rank 0 prints the lines, once); on the card it
    needs a card a rank and exits 2 with that reason otherwise."""
    from repro_torch.launch import train
    assert train.main(["--smoke", "--device", "cpu", "--data", "2",
                       "--steps", "2", "--batch", "4", "--seq", "16"]) == 0
    out = capfd.readouterr().out
    assert out.count("mesh: {'data': 2, 'model': 1}; params sharded") == 1
    assert re.search(r"2 steps in [\d.]+s \(\d+ tok/s\); loss", out), out
    n = torch.cuda.device_count()
    if n < 2:
        assert train.main(["--smoke", "--device", "cuda", "--data",
                           "2"]) == 2
        assert f"2 ranks need a CUDA card each; {n} found" in \
            capfd.readouterr().err


def test_train_tiny_example_runs_on_the_cpu(capsys, tmp_path):
    from repro_torch.examples import train_tiny
    train_tiny.main(["--device", "cpu", "--steps", "8", "--batch", "2",
                     "--seq", "16", "--ckpt", str(tmp_path / "t.npz")])
    out = capsys.readouterr().out
    assert "(decreased)" in out and "checkpoint round-trip OK" in out
