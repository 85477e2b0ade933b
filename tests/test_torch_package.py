"""The port stands alone: it imports neither JAX nor the reference
package, and its entry points run on the card unless told otherwise."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

PKG = Path(repro_torch.__file__).resolve().parent
SRC = PKG.parent


def _modules():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_every_module_imports_without_jax_or_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.MULTILINE)


def test_sources_name_no_jax_or_reference_import():
    offenders = []
    for path in PKG.rglob("*.py"):
        for m in _FORBIDDEN.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(SRC)}: {m.group(0).strip()}")
    assert not offenders, offenders


COPIED = [f"core/{m}.py" for m in (
    "request", "bucket", "batcher", "scheduler", "monitor", "serving_loop",
    "paging", "prefix_cache", "retention", "telemetry", "faults",
    "recovery", "simulator", "baselines", "analysis")] \
    + ["models/config.py", "data/workload.py", "data/trace.py"] \
    + [f"configs/{m}.py" for m in ("__init__", "yi_6b", "stablelm_1_6b",
                                   "llama2_13b", "rwkv6_3b",
                                   "recurrentgemma_2b",
                                   "qwen3_moe_235b_a22b",
                                   "llama4_scout_17b_a16e", "hubert_xlarge",
                                   "llama_3_2_vision_90b",
                                   "nemotron_4_340b")]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_the_reference(rel):
    """Each JAX-free module the port copies is the reference's source with
    ``repro.`` rewritten to ``repro_torch.``: the two engines' decisions
    come from the same code."""
    ref = (SRC / "repro" / rel).read_text()
    assert (PKG / rel).read_text() == re.sub(r"\brepro\.", "repro_torch.",
                                             ref)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (BucketServeScheduler, MemoryBudget,
                                  SchedulerConfig)
    from repro_torch.core.engine import ServingEngine, TorchEngineBackend
    from repro_torch.launch import serve
    from repro_torch.models import rglru, rwkv
    from repro_torch.models import transformer as tfm

    cfg = get_smoke_config("qwen3-14b", max_seq_len=64)
    model = tfm.init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sched = BucketServeScheduler(
        cfg, MemoryBudget(2 ** 30, 1, 0), SchedulerConfig())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ServingEngine(cfg, model, sched)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TorchEngineBackend(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tfm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rwkv.init_state(get_smoke_config("rwkv6-3b"), 1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rglru.init_state(get_smoke_config("recurrentgemma-2b"), 1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--smoke", "--requests", "1"])


TRAINING_MODULES = ("repro_torch.train.optimizer",
                    "repro_torch.train.train_loop",
                    "repro_torch.train.checkpoint",
                    "repro_torch.data.tokens", "repro_torch.launch.train",
                    "repro_torch.kernels.autograd",
                    "repro_torch.examples.train_tiny")


def test_training_modules_are_in_the_import_check():
    """The training slice's modules are among those the no-JAX import
    check imports."""
    assert set(TRAINING_MODULES) <= set(_modules())


def test_training_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import tokens
    from repro_torch.examples import train_tiny
    from repro_torch.launch import train
    from repro_torch.train import train_loop

    cfg = get_smoke_config("qwen3-14b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        next(tokens.batches(cfg, 1, 8))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_loop.train(cfg, 1, iter(()))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_tiny.main(["--steps", "1"])


DISTRIBUTION_MODULES = ("repro_torch.launch.mesh",
                        "repro_torch.sharding.context",
                        "repro_torch.sharding.partition",
                        "repro_torch.sharding.collectives",
                        "repro_torch.sharding.rows",
                        "repro_torch.core.driver")


@pytest.mark.parametrize("module", DISTRIBUTION_MODULES)
def test_distribution_modules_are_in_the_import_check(module):
    """The distribution slice's modules are among those the no-JAX import
    check imports."""
    assert module in _modules()


def test_distribution_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, capsys):
    from repro_torch.launch import mesh, serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mesh.init_distributed(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mesh.make_host_mesh(1, 1)
    # the serve launcher under a mesh defaults to the card too
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--smoke", "--data", "2", "--model", "2"])


def test_cpu_serve_launcher_prints_the_summary(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--device", "cpu", "--dtype", "f32",
                "--requests", "4", "--paged", "--page-size", "32",
                "--chunk", "64", "--slots", "4"])
    out = capsys.readouterr().out
    assert re.search(r"served 4/4 requests, \d+ tokens in", out), out
    assert "prefill shapes:" in out and "buckets: [" in out
    assert "kernel launches: flash_prefill 0, paged_flash_decode 0, " \
           "flash_decode 0" in out


def test_cpu_serve_launcher_serves_an_int8_pool(capsys):
    """``--kv-dtype int8`` serves every request over an int8 paged pool
    and names it in the summary, with the pages the same byte budget buys
    at int8 (about twice the bf16 pool's)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.paging import device_pool_pages
    from repro_torch.launch import serve
    pages = {}
    for kv in ("bf16", "int8"):
        serve.main(["--smoke", "--device", "cpu", "--dtype", "f32",
                    "--requests", "4", "--paged", "--page-size", "32",
                    "--chunk", "64", "--slots", "4", "--kv-dtype", kv])
        out = capsys.readouterr().out
        assert re.search(r"served 4/4 requests, \d+ tokens in", out), out
        m = re.search(rf"pages: (\d+) x 32 tok \({kv} pool\), free (\d+)",
                      out)
        assert m and m[1] == m[2], out
        pages[kv] = int(m[1])
    cfg8 = get_smoke_config("qwen3-14b", max_seq_len=256,
                            kv_cache_dtype="int8")
    assert pages["int8"] == device_pool_pages(cfg8, 4 * 256, 32) - 1
    assert pages["int8"] >= 1.8 * pages["bf16"]
    assert "paged_flash_decode_int8 0" in out


def test_cpu_serve_launcher_resumes_sessions_and_spills(capsys):
    """Two 2-turn sessions with the spill tier: ``--session-ttl 0``
    expires each finished turn's tail at once, so it is demoted to the
    host and the next turn restores it; the summary shows the session
    hits and the spilled and restored pages."""
    from repro_torch.launch import serve
    serve.main(["--smoke", "--device", "cpu", "--dtype", "f32",
                "--sessions", "2", "--turns", "2", "--kv-spill",
                "--session-ttl", "0", "--page-size", "32", "--chunk", "64"])
    out = capsys.readouterr().out
    assert re.search(r"served 4/4 requests, \d+ tokens in", out), out
    hits = re.search(r"session hits (\d+)/(\d+)", out)
    assert hits and int(hits[1]) > 0 and int(hits[2]) == 4, out
    spill = re.search(r"spill\[bf16\]: (\d+) pages \(\d+ B\) out, "
                      r"(\d+) back", out)
    assert spill and int(spill[1]) > 0 and int(spill[2]) > 0, out
    assert re.search(r"prefix hits [1-9]\d*/4", out), out


def test_launcher_refuses_paged_for_an_attention_free_config(monkeypatch,
                                                            capsys):
    """``--paged`` with rwkv6-3b exits with a message naming the config,
    before the default pool size divides by its zero KV bytes a token."""
    from repro_torch.launch import serve

    def unreachable(*args):
        raise AssertionError("default_pool_tokens reached")
    monkeypatch.setattr(serve, "default_pool_tokens", unreachable)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--smoke", "--arch", "rwkv6-3b", "--device", "cpu",
                    "--paged"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "rwkv6-3b" in err and "--paged" in err, err


def test_cpu_serve_launcher_runs_rwkv(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--arch", "rwkv6-3b", "--device", "cpu",
                "--dtype", "f32", "--requests", "4", "--chunk", "64",
                "--slots", "4"])
    out = capsys.readouterr().out
    assert re.search(r"served 4/4 requests, \d+ tokens in", out), out
    assert "wkv6 0" in out


def test_cpu_serve_launcher_runs_recurrentgemma_on_the_paged_pool(capsys):
    """recurrentgemma-2b's local-attention rings page and its RG-LRU
    carries stay per slot: every request served and every page free (on
    the CPU the wrappers run their plain versions: no launch counted)."""
    from repro_torch.launch import serve
    serve.main(["--smoke", "--arch", "recurrentgemma-2b", "--device", "cpu",
                "--dtype", "f32", "--paged", "--page-size", "32",
                "--requests", "4", "--slots", "4"])
    out = capsys.readouterr().out
    assert re.search(r"served 4/4 requests, \d+ tokens in", out), out
    m = re.search(r"pages: (\d+) x 32 tok \(bf16 pool\), free (\d+)", out)
    assert m and m[1] == m[2], out
    assert "paged_flash_decode 0" in out


def test_long_context_example_serves_each_family_on_the_cpu(capsys):
    """The twin of ``examples/long_context_serving.py`` at smoke size:
    rwkv6-3b, recurrentgemma-2b and the dense sliding-window variant each
    serve their 8 prompts of 100-200 tokens, and the full-scale memory
    lines are those of the reference's configs."""
    from repro_torch.examples import long_context_serving as ex
    served = ex.main(["--device", "cpu"])
    assert len(served) == 3
    for name, outs in served.items():
        assert len(outs) == 8 and all(len(o) == 6 for o in outs.values()), \
            name
    rows = {r[0]: r for r in ex.memory_models()}
    assert set(rows) == {"qwen3-14b", "qwen3-14b+swa", "rwkv6-3b",
                         "recurrentgemma-2b"}
    assert rows["recurrentgemma-2b"][3] == 2048
    assert "served 8/8" in capsys.readouterr().out


def test_quickstart_example_serves_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    done = quickstart.main(["--device", "cpu", "--requests", "6",
                            "--chunk", "32"])
    assert len(done) == 6
    out = capsys.readouterr().out
    assert "served 6/6 requests" in out and "prefill shapes:" in out


def test_init_params_shapes_and_scales():
    """The port's own init: reference shapes, normal times fan_in**-0.5,
    zero norms, reproducible from the seed."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    cfg = get_smoke_config("qwen3-14b", max_seq_len=64)
    a = tfm.init_params(cfg, seed=3, device="cpu")
    b = tfm.init_params(cfg, seed=3, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    blk = a.groups[0][0][0]
    assert blk.attn.wq.shape == (cfg.d_model, cfg.q_dim)
    assert blk.mlp.down.shape == (cfg.d_ff, cfg.d_model)
    assert float(blk.ln1.abs().max()) == 0.0
    std = float(blk.mlp.down.std())
    assert abs(std - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
