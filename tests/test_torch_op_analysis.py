"""The port's op-level roofline counter (``launch/op_analysis.py``), its
kernel formulas (``kernels/cost.py``) and its dry-run
(``launch/dryrun.py``): twins of ``tests/test_hlo_analysis.py`` on
torch's fake process group (collectives that move nothing, one process),
each formula against its plain version's traced FLOPs, the unfused count
of smoke steps against the reference's HLO count of the same jitted
functions, a step counted on real tensors against the same step on fake
ones, and one dry-run pair end to end."""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_smoke_config as j_smoke
from repro.launch import hlo_analysis
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun
from repro_torch.launch import op_analysis as oa
from repro_torch.launch.input_specs import params_shapes
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.sharding import collectives, partition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def fake_group(world: int):
    """Rank 0 of ``world`` on torch's fake process group."""
    dryrun.start_fake_group(world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------ twins of test_hlo_analysis.py --
def test_loop_of_products_flops_exact():
    """8 products in a loop, the weights' columns cut over ``model`` and
    the rows over ``data`` on (2, 4): FLOPs a rank exact (layers x 2MNK of
    its shard), each layer's output all-gathered over ``model``."""
    with fake_group(8):
        mesh = make_host_mesh(2, 4, device="cpu")
        g = mesh.group("model")

        def f(w, x):
            c = x
            for wl in w:
                y = collectives.gather_from(c @ wl, g, -1)
                c = y[:, :256] + y[:, 256:]
            return c
        with FakeTensorMode():
            w = torch.empty(8, 256, 512 // 4, dtype=torch.bfloat16)
            x = torch.empty(4 // 2, 256, dtype=torch.bfloat16)
            st = oa.count(f, w, x).stats
    assert st.flops == 8 * 2 * 2 * 256 * (512 // 4)
    assert st.coll["all-gather"] == 8 * 2 * 512 * 2


def test_collective_bytes_counted_every_layer():
    """6 row-parallel layers on 4 ranks: an all-reduce of the (8, 128) f32
    partial sums a layer."""
    with fake_group(4):
        mesh = make_host_mesh(1, 4, device="cpu")
        g = mesh.group("model")

        def f(w, x):
            c = x
            for wl in w:
                c = collectives.reduce_from(
                    collectives.scatter_to(c, g, -1) @ wl, g)
            return c
        with FakeTensorMode():
            w = torch.empty(6, 128 // 4, 128)
            x = torch.empty(8, 128)
            st = oa.count(f, w, x).stats
    assert st.coll["all-reduce"] >= 6 * 8 * 128 * 4, st.coll


def _prefill_args(B=2, T=64, H=4, Hkv=2, Dh=32, dtype=torch.float32):
    return (torch.empty(B, T, H, Dh, dtype=dtype),
            torch.empty(B, T, Hkv, Dh, dtype=dtype),
            torch.empty(B, T, Hkv, Dh, dtype=dtype))


def test_kernel_scope_keeps_flops_and_drops_bytes():
    """A non-causal full-length prefill: the kernel's formula has the
    plain version's FLOPs and fewer bytes (its intermediates stay on
    chip)."""
    with FakeTensorMode():
        args = _prefill_args()
        fused = oa.count(ops.flash_prefill, *args, causal=False)
        plain = oa.count(ops.flash_prefill, *args, causal=False,
                         fused_kernels=False)
    assert fused.kernels == {"flash_prefill": 1} and not plain.kernels
    assert fused.stats.flops == plain.stats.flops > 0
    assert fused.stats.bytes < plain.stats.bytes


# ------------------------------------------ each formula against its plain --
def _decode_args(int8, paged, B=2, S=128, H=4, Hkv=2, Dh=32, page=16):
    f32 = torch.float32
    kv = torch.int8 if int8 else f32
    lead = (B * S // page, page) if paged else (B, S)
    k, v = (torch.empty(*lead, Hkv, Dh, dtype=kv) for _ in range(2))
    args = [torch.empty(B, H, Dh), k, v]
    if int8:
        args += [torch.empty(*lead, Hkv, dtype=f32) for _ in range(2)]
    if paged:
        args.append(torch.empty(B, S // page, dtype=torch.int32))
    args.append(torch.empty(B, dtype=torch.int32))
    return args, (dict(s_len=S) if paged else {})


DECODE_KERNELS = {"flash_decode": (ops.flash_decode, False, False),
                  "paged_flash_decode": (ops.paged_flash_decode, False, True),
                  "flash_decode_int8": (ops.flash_decode_int8, True, False),
                  "paged_flash_decode_int8": (ops.paged_flash_decode_int8,
                                              True, True)}


@pytest.mark.parametrize("name", ["flash_prefill", *DECODE_KERNELS])
def test_attention_formula_equals_the_plain_flops(name):
    """At non-causal full-length shapes (every key of every row live) an
    attention kernel's formula has its plain version's traced FLOPs."""
    with FakeTensorMode():
        if name == "flash_prefill":
            fn, args, kw = ops.flash_prefill, _prefill_args(), dict(
                causal=False)
        else:
            fn, int8, paged = DECODE_KERNELS[name]
            args, kw = _decode_args(int8, paged)
        fused = oa.count(fn, *args, **kw)
        plain = oa.count(fn, *args, fused_kernels=False, **kw)
    assert fused.kernels == {name: 1}
    assert fused.kernel_stats[name].flops == plain.stats.flops > 0


def test_wkv6_formula_against_the_plain_flops():
    """The plain ``wkv6`` traces one product a step, ``r.S`` (2 FLOPs a
    state element); the formula counts the recurrence's 5 and the rank-1
    bonus term's 5 a channel."""
    B, T, H, hs = 2, 8, 2, 16
    with FakeTensorMode():
        r, k, v, w = (torch.empty(B, T, H, hs) for _ in range(4))
        u, s0 = torch.empty(H, hs), torch.empty(B, H, hs, hs)
        fused = oa.count(ops.wkv6, r, k, v, w, u, s0)
        plain = oa.count(ops.wkv6, r, k, v, w, u, s0, fused_kernels=False)
    elems = B * T * H * hs
    assert plain.stats.flops == 2 * elems * hs
    assert fused.kernel_stats["wkv6"].flops == \
        2.5 * plain.stats.flops + 5 * elems


@pytest.mark.parametrize("with_dsT", [True, False])
def test_wkv6_bwd_formula_against_the_plain_flops(with_dsT):
    """The plain ``wkv6_bwd`` traces four products a step (``S dy``,
    ``G v``, ``G^T k``, ``sum_j G S``: 8 FLOPs a state element); the
    formula counts 14 a state element (the state's recompute and G's
    update besides) and the rank-1 terms' 16 a channel.  Its bytes are
    each input read and each gradient written once."""
    B, T, H, hs = 2, 8, 2, 16
    with FakeTensorMode():
        r, k, v, w, dy = (torch.empty(B, T, H, hs) for _ in range(5))
        u, s0 = torch.empty(H, hs), torch.empty(B, H, hs, hs)
        dsT = torch.empty(B, H, hs, hs) if with_dsT else None
        args = (r, k, v, w, u, s0, dy, dsT)
        fused = oa.count(ops.wkv6_bwd, *args)
        plain = oa.count(ops.wkv6_bwd, *args, fused_kernels=False)
    elems = B * T * H * hs
    assert fused.kernels == {"wkv6_bwd": 1} and not plain.kernels
    assert plain.stats.flops == 8 * elems * hs
    assert fused.kernel_stats["wkv6_bwd"].flops == \
        1.75 * plain.stats.flops + 16 * elems
    state = 4 * B * H * hs * hs
    assert fused.kernel_stats["wkv6_bwd"].bytes == \
        (6 * 4 + 3 * 4) * elems + 2 * 4 * H * hs \
        + (3 if with_dsT else 2) * state        # r k v dr dk dv, w dy dw


def test_real_count_equals_fake_count_of_an_rwkv_train_step():
    """A smoke rwkv6-3b train step counted on real CPU tensors (the plain
    forward and backward run, unseen, under the kernels' formulas) and
    traced on fake ones: ``wkv6`` and its backward ``wkv6_bwd`` once a
    layer each, and the same FLOPs, bytes and ops."""
    from repro_torch.train import optimizer, train_loop
    cfg = dataclasses.replace(get_smoke_config("rwkv6-3b"), n_layers=2)
    step = train_loop.make_train_step(cfg, optimizer.AdamWConfig())

    def counted(model):
        batch = {"tokens": torch.zeros(B, T, dtype=torch.int32)}
        return oa.count(step, model, optimizer.init(bridge.leaves(model)),
                        batch)
    real = counted(tfm.init_params(cfg, 0, torch.float32, "cpu"))
    with FakeTensorMode():
        fake = counted(params_shapes(cfg, torch.float32, "cpu"))
    assert real.kernels == fake.kernels == {"wkv6": 2, "wkv6_bwd": 2}
    assert real.ops == fake.ops
    assert real.stats == fake.stats


def test_grouped_mm_formula_is_the_plain_loop_over_the_experts():
    """The plain grouped product multiplies every row by every expert;
    the formula counts each row's own (the reference's ragged_dot count
    divided by E), in the fused and the unfused count alike."""
    M, K, N, E = 32, 16, 24, 4
    with FakeTensorMode():
        x, w = torch.empty(M, K), torch.empty(E, K, N)
        offs = torch.empty(E, dtype=torch.int32)
        plain = oa.count(moe.grouped_mm_plain, x, w, offs)
        counts = [oa.count(moe.grouped_mm, x, w, offs, fused_kernels=f)
                  for f in (True, False)]
    for c in counts:
        assert c.kernels == {"grouped_mm": 1}
        assert c.stats.flops == plain.stats.flops / E == 2 * M * K * N


@pytest.mark.parametrize("paged", [False, True])
def test_decode_count_takes_the_live_context(paged):
    """``count(..., context=)``: a decode call counts the live slots the
    host gives (clamped to the span), not its whole span; without it the
    whole span."""
    B, S, H, Hkv, Dh, page = 2, 128, 4, 2, 32, 16
    fn = ops.paged_flash_decode if paged else ops.flash_decode
    with FakeTensorMode():
        args, kw = _decode_args(False, paged, B=B, S=S, H=H, Hkv=Hkv, Dh=Dh,
                                page=page)
        live = oa.count(fn, *args, context=[40, 200], **kw).stats
        whole = oa.count(fn, *args, **kw).stats
    paging = dict(page=page) if paged else {}
    assert (live.flops, live.bytes) == cost.decode(B, H, Hkv, Dh, 4,
                                                   [40, S], **paging)
    assert live.flops == 4 * H * Dh * (40 + S)
    assert (whole.flops, whole.bytes) == cost.decode(B, H, Hkv, Dh, 4, S,
                                                     **paging)


ENTRY_KERNELS = {
    "flash_prefill": (ops.flash_prefill, "_prefill", "flash_prefill"),
    "paged_flash_decode": (ops.paged_flash_decode, "paged_decode_attn",
                           "paged_flash_decode")}


@pytest.mark.parametrize("name", ENTRY_KERNELS)
def test_count_on_device_tensors_keeps_the_kernel(name, monkeypatch):
    """On real tensors off the CPU (``meta`` here, the card's tensors on
    the machine with one) a fused count reaches the kernel's wrapper,
    once, and an unfused count raises before any kernel or plain version
    runs: the plain version never takes a kernel's place."""
    fn, module, attr = ENTRY_KERNELS[name]
    launched = []

    def kernel(q, *args, **kwargs):
        launched.append(q.shape)
        return torch.empty_like(q)
    monkeypatch.setattr(getattr(ops, module), attr, kernel)
    if name == "flash_prefill":
        args, kw = [t.to("meta") for t in _prefill_args()], {}
    else:
        args, kw = _decode_args(False, True)
        args = [t.to("meta") for t in args]
    fused = oa.count(fn, *args, **kw)
    assert fused.kernels == {name: 1} and len(launched) == 1
    with pytest.raises(ValueError, match="unfused count"):
        oa.count(fn, *args, fused_kernels=False, **kw)
    assert len(launched) == 1


def test_prefill_formula_counts_the_masks_pairs():
    """Causal, windowed and ragged pairs against a count by hand."""
    pairs, keys = cost.attention_pairs(6, 10, np.array([10, 4]),
                                       causal=True, window=3, q_offset=2)
    want = [sum(len([j for j in range(L) if j <= p and p - j < 3])
                for p in range(2, 8)) for L in (10, 4)]
    assert list(pairs) == want and list(keys) == [8, 4]


# -------------------------------------- unfused counts against the HLO's --
SMOKE_ARCHS = ("qwen3-14b", "qwen3-moe-235b-a22b")
B, T, S = 2, 32, 64


def _ref_stats(arch):
    cfg = j_smoke(arch)
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tok = jnp.zeros((B, T), jnp.int32)
    pre = jax.jit(lambda p, t: jtfm.prefill(cfg, p, tokens=t, cache_len=S))
    _, cache = pre(params, tok)
    dec = jax.jit(lambda p, t, c: jtfm.decode_step(cfg, p, t, c))
    return {
        "prefill": hlo_analysis.module_stats(
            pre.lower(params, tok).compile().as_text()),
        "decode": hlo_analysis.module_stats(
            dec.lower(params, tok[:, 0], cache).compile().as_text())}


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_unfused_flops_match_the_reference_hlo(arch):
    """The smoke prefill and decode step, traced op by op with the plain
    versions: FLOPs within 2% of ``hlo_analysis.module_stats`` of the
    same jitted functions on one CPU device (the same products)."""
    want = _ref_stats(arch)
    cfg = get_smoke_config(arch)
    with FakeTensorMode():
        model = params_shapes(cfg, torch.float32, "cpu")
        tok = torch.empty(B, T, dtype=torch.int32)
        pre = oa.count(tfm.prefill, cfg, model, tok, cache_len=S,
                       fused_kernels=False)
        _, cache = pre.result
        dec = oa.count(tfm.decode_step, cfg, model, tok[:, 0], cache,
                       fused_kernels=False)
    for name, got in (("prefill", pre), ("decode", dec)):
        ref = want[name].flops
        assert abs(got.stats.flops - ref) <= 0.02 * ref, \
            (name, got.stats.flops, ref)


# ------------------------------------------------ real against fake counts --
@pytest.mark.parametrize("step", ["decode", "chunk"])
def test_real_count_equals_fake_count(step):
    """A smoke paged decode step and a chunk at an int offset counted on
    real CPU tensors (the plain versions run, unseen, under the kernels'
    formulas) and traced on fake ones: the same FLOPs, bytes, ops and
    kernel calls."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), max_seq_len=S)
    model = tfm.init_params(cfg, 0, torch.float32, "cpu")

    def inputs(device):
        toks = torch.zeros(B, 8, dtype=torch.int32, device=device)
        if step == "decode":
            cache = tfm.init_paged_cache(cfg, B, S, B * S // 16 + 1, 16,
                                         device=device)
            return (tfm.decode_step, (toks[:, 0], cache),
                    dict(page_size=16, paged_len=S))
        cache = tfm.init_cache(cfg, B, S, device=device)
        lens = torch.full((B,), 40, dtype=torch.int32, device=device)
        return tfm.prefill_chunk, (toks, cache, 24, lens), {}

    fn, args, kw = inputs("cpu")
    real = oa.count(fn, cfg, model, *args, **kw)
    with FakeTensorMode():
        fmodel = params_shapes(cfg, torch.float32, "cpu")
        fn, args, kw = inputs("cpu")
        fake = oa.count(fn, cfg, fmodel, *args, **kw)
    assert real.kernels == fake.kernels and sum(real.kernels.values()) == 2
    assert real.ops == fake.ops
    assert real.stats == fake.stats
    assert real.memory == fake.memory


# ------------------------------------------------------------ the dry-run --
def test_dryrun_traces_an_rwkv_train_pair():
    """rwkv6-3b train_4k on the single-pod mesh, traced on fake CPU
    tensors in this process: the step's ``roofline`` with ``wkv6``
    forward (and remat's recompute) and its backward kernel by formula
    a layer; ``roofline_plain``, the per-step loop over 4096 steps
    forward and backward, skipped with its reason."""
    rec = dryrun.trace_one("rwkv6-3b", "train_4k", False, "cpu")
    assert "skipped" not in rec and "error" not in rec
    n = get_config("rwkv6-3b").n_layers
    assert rec["kernels"] == {"wkv6": 2 * n, "wkv6_bwd": n}
    assert 0 < rec["roofline"]["useful_ratio"] <= 1
    assert "loop over 4096 steps" in rec["roofline_plain"]["skipped"]



def test_dryrun_pair_records_the_reference_fields(tmp_path):
    """qwen3-14b decode_32k on the single-pod mesh, traced on fake CPU
    tensors in a subprocess: every field, argument bytes equal to this
    rank's parameters, cache and token, and 0 < useful_ratio <= 1."""
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
         "--arch", "qwen3-14b", "--shape", "decode_32k", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads(out.read_text())["qwen3-14b|decode_32k|single"]
    assert set(rec) == {"arch", "shape", "variant", "mesh", "n_devices",
                        "device", "trace_s", "memory", "roofline",
                        "roofline_plain", "collectives", "kernels"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "alias_bytes", "temp_bytes"}
    terms = {"flops_per_device", "bytes_per_device", "coll_bytes_per_device",
             "n_devices", "model_flops", "compute_s", "memory_s",
             "collective_s", "dominant", "useful_ratio"}
    assert set(rec["roofline"]) == set(rec["roofline_plain"]) == terms
    assert set(rec["collectives"]) == set(oa.COLLECTIVES)
    assert rec["n_devices"] == 256 and rec["device"] == "cpu"
    for tag in ("roofline", "roofline_plain"):
        assert 0 < rec[tag]["useful_ratio"] <= 1

    cfg = get_config("qwen3-14b")
    mesh = make_production_mesh()
    model = params_shapes(cfg, torch.bfloat16, "meta")
    specs = partition.param_specs(cfg, model, mesh)
    params = sum(
        int(np.prod(partition.local_shape(
            partition.reference_shape(leaf), specs[key], mesh))) * 2
        for key, leaf in bridge.leaves(model).items())
    whole = tfm.init_cache(cfg, 128, 32768, torch.bfloat16, "meta")
    cspecs = partition.cache_specs(cfg, whole, mesh, 128)
    cache = []
    partition.map_leaves(lambda t, spec: cache.append(
        int(np.prod(partition.local_shape(t.shape, spec, mesh)))
        * t.element_size()), whole, cspecs)
    assert rec["memory"]["argument_bytes"] == params + sum(cache) + 128 * 4
