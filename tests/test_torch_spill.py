"""The host spill tier in the port's engine, against its own run
without a spill tier, and the copier bit for bit.

The port's counterpart of ``tests/test_kv_spill.py``'s
``TestSpillEngineAcceptance``, with the reference's assertions: on the
sessions x turns workload with a pool tight enough that retention
without a host tier destroys retained pages, the spill run's ids equal
the no-spill run's while later turns prefill at most 60% of its prompt
tokens, and both tiers balance.  A page spilled, then overwritten in the
pool, comes back as it was spilled.  The parity with the JAX engine on
``TestSpillBackendParity``'s workload is in
``tests/test_torch_spill_parity.py``, a file of its own so that the two
files run on two workers.
"""
import functools

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro.models import attention as jattn
from repro_torch.core.engine import ServingEngine as TorchEngine
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm

from test_torch_prefix import (PAGE, one_torch_thread, serve,  # noqa: F401
                               session_workload, smoke_cfg, torch_model)

TIGHT_POOL = 12 * PAGE        # retention without spill drops sessions
HOST = 64 * PAGE
TIME_SCALE = 10.0             # engine seconds per wall second


@functools.lru_cache(maxsize=None)
def spill_run(host, spill_dtype=""):
    """``TestSpillEngineAcceptance._run`` in the port: 3 sessions x 4
    turns over a 12-page pool.  Each run is made once for the file.  A
    spill run waits out the retention layer's 60 s restore reservation of
    two held turns (the reference's engine waits the same); the engine's
    clock runs ``TIME_SCALE`` times the wall clock, so the wait takes 6 s
    and the 1000 s session TTL stays far beyond the run."""
    cfg = smoke_cfg("torch", max_seq_len=1024)
    return serve("torch", cfg, session_workload("torch", cfg, sessions=3,
                                                turns=4, utter=200, out=8),
                 pool_tokens=TIGHT_POOL, session_ttl=1000.0,
                 host_pool_tokens=host, spill_dtype=spill_dtype,
                 time_scale=TIME_SCALE)


def check_tiers_balance(run):
    a = run.be.alloc
    assert a.free_pages() + a.live_pages() == a.n_pages
    assert a.free_host_slots() + a.spilled_slots() == a.host_pages
    run.be.retention.clear(a)
    assert a.free_pages() == a.n_pages
    assert a.spilled_slots() == 0


def test_spill_equals_no_spill_and_prefills_40pct_less_than_unpin():
    runs = {host: spill_run(host) for host in (None, HOST)}
    for run in runs.values():
        check_tiers_balance(run)
    unpin, spill = runs[None].res, runs[HOST].res
    # the tight pool really forced destructive eviction without the tier
    assert (unpin.sessions_evicted + unpin.sessions_expired
            + unpin.prefix_evictions) > 0
    assert unpin.spilled_pages == 0
    assert spill.spilled_pages > 0
    assert spill.restored_pages > 0 and spill.restored_tokens > 0
    assert runs[HOST].outs == runs[None].outs
    assert runs[HOST].prompts == runs[None].prompts

    def later(run):
        return sum(r.prefilled_tokens for r in run.reqs if r.turn >= 1)
    assert later(runs[HOST]) <= 0.6 * later(runs[None]), \
        (later(runs[HOST]), later(runs[None]))


def test_restore_latency_lands_on_ttft():
    """Held turns pay the restore wait in their TTFT."""
    run = spill_run(HOST)
    assert run.res.spill_hold_events > 0
    for q in run.reqs:
        assert q.first_token >= q.arrival
        assert q.ttft() < float("inf")


def test_int4_spill_leaves_dispatch_unchanged():
    """int4 spill is lossy, but the batches that dispatch, the spill and
    restore counts stay those of the raw (bf16 pass-through) spill run,
    with fewer bytes moved and less priced restore time."""
    raw, q4 = spill_run(HOST), spill_run(HOST, "int4")
    assert raw.res.spilled_pages > 0
    assert q4.dispatched == raw.dispatched
    assert q4.res.spilled_pages == raw.res.spilled_pages
    assert q4.res.restored_pages == raw.res.restored_pages
    assert q4.res.spilled_bytes < raw.res.spilled_bytes / 2
    assert q4.res.restore_time_total < raw.res.restore_time_total


def _copier_engine(dtype, spill_dtype):
    cfg = smoke_cfg("torch", max_seq_len=256)
    model = torch_model() if dtype == torch.float32 else \
        ttfm.init_params(cfg, seed=0, dtype=dtype, device="cpu")
    eng = TorchEngine(cfg, model, tcore.BucketServeScheduler(
        cfg, tcore.MemoryBudget(2 ** 30, 1, 0), tcore.SchedulerConfig()),
        max_slots=2, paged=True, page_size=32, session_ttl=10.0,
        host_pool_tokens=8 * 32, spill_dtype=spill_dtype, device="cpu")
    return eng.backend


def _expected_round_trip(page, spill_dtype):
    """What a restore must give for a spilled page: its bits for a raw
    tier, the codecs' round trip for a compressed one."""
    if spill_dtype in ("", "bf16"):
        return page
    x = page.float().numpy()
    if spill_dtype == "int4":
        packed, scale = tattn.quantize_kv_int4(x)
        y = tattn.dequantize_kv_int4(packed, scale, x.shape[-1])
    else:
        scale = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(np.float32)
        y = np.clip(np.rint(x / scale[..., None]), -127, 127).astype(
            np.int8).astype(np.float32) * scale[..., None]
    return torch.from_numpy(y).to(page.dtype)


@pytest.mark.parametrize("dtype,spill_dtype", [
    (torch.float32, ""), (torch.bfloat16, "bf16"), (torch.bfloat16, "int8"),
    (torch.float32, "int4")])
def test_copier_captures_the_page_at_spill_time(dtype, spill_dtype):
    """Spill a page, overwrite it in the pool (as a reallocation would
    before the next poll), poll, restore into another page: the restored
    page is the page as it was at spill time, bit for bit for a raw tier.
    A copier that kept a view of the pool would restore the overwrite."""
    be = _copier_engine(dtype, spill_dtype)
    cp = be.retention.copier
    leaves = be.pool_cache["groups"][0][0]
    gen = torch.Generator().manual_seed(1)
    src, dst, hslot = 2, 5, 3
    for leaf in leaves.values():
        leaf[:, src] = torch.randn(leaf[:, src].shape, generator=gen)
        leaf[:, dst] = 0
    want = {k: _expected_round_trip(leaf[:, src].clone(), spill_dtype)
            for k, leaf in leaves.items()}
    cp.spill(src, hslot)
    for leaf in leaves.values():
        leaf[:, src] = torch.randn(leaf[:, src].shape, generator=gen)
    cp.poll()
    cp.restore(hslot, dst)
    cp.poll()
    for k, leaf in leaves.items():
        assert leaf.dtype == dtype
        assert torch.equal(leaf[:, dst].view(torch.uint8),
                           want[k].view(torch.uint8)), k
        assert not torch.equal(leaf[:, dst], leaf[:, src])


def test_copier_drop_discards_a_staged_spill():
    be = _copier_engine(torch.float32, "")
    cp = be.retention.copier
    cp.spill(1, 0)
    cp.drop(0)
    cp.poll()
    assert not cp._host          # nothing reached host memory


@pytest.mark.parametrize("shape", [(2, 3, 4, 64), (5, 2, 7), (3, 1, 1)])
def test_int4_codecs_match_the_reference(shape):
    """The port's numpy codecs are the reference's, bit for bit, odd
    last axes included."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    tp, ts = tattn.quantize_kv_int4(x)
    jp, js = jattn.quantize_kv_int4(x)
    assert np.array_equal(tp, jp) and np.array_equal(ts, js)
    n = shape[-1]
    assert np.array_equal(tattn.dequantize_kv_int4(tp, ts, n),
                          jattn.dequantize_kv_int4(jp, js, n))
    q = np.random.default_rng(1).integers(-8, 8, size=shape).astype(np.int8)
    assert np.array_equal(tattn.pack_int4(q), jattn.pack_int4(q))
    assert np.array_equal(tattn.unpack_int4(tattn.pack_int4(q), n), q)


def test_int4_round_trip_logit_drift_bounded():
    """``TestInt4LogitDrift`` in the port: a prefilled cache through the
    int4 codecs moves the next decode step's logits by < 1.5."""
    cfg = smoke_cfg("torch")
    model = torch_model()
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    logits, cache = ttfm.prefill(cfg, model, tok, cache_len=40)
    rt = {"pos": cache["pos"].clone(), "groups": tuple(
        tuple({k: _expected_round_trip(v, "int4") for k, v in slot.items()}
              for slot in group) for group in cache["groups"])}
    nxt = logits.argmax(-1).to(torch.int32)
    l1, _ = ttfm.decode_step(cfg, model, nxt, cache)
    l2, _ = ttfm.decode_step(cfg, model, nxt, rt)
    assert bool(torch.isfinite(l2).all())
    assert float((l1 - l2).abs().max()) < 1.5


def test_spill_dtype_must_be_known():
    cfg = smoke_cfg("torch", max_seq_len=256)
    sched = tcore.BucketServeScheduler(
        cfg, tcore.MemoryBudget(2 ** 30, 1, 0), tcore.SchedulerConfig())
    with pytest.raises(ValueError, match="spill_dtype"):
        TorchEngine(cfg, torch_model(), sched, paged=True, session_ttl=1.0,
                    host_pool_tokens=1024, spill_dtype="fp8", device="cpu")
