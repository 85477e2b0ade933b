"""The port's host spill tier against the JAX engine's.

``tests/test_kv_spill.py``'s ``TestSpillBackendParity`` holds the JAX
engine against the cost model; here the same workload (2 sessions x 4
turns over a 10-page pool, a 64-page host tier, raw and int4 spill)
goes through the JAX engine and the port with the same weights (f32).
The dispatched batches, the spill, restore, hold and session counts,
the bytes moved, the priced restore time and the token ids must be the
same.

On the wall clock each of these runs waits out the retention layer's
60 s restore reservation of two held turns, in both engines alike, so
the two engines of a case run side by side in two threads.  Dispatch
decisions do not depend on the clock's pace: the reference holds them
equal between its wall-clock engine and its virtual-clock cost model.
"""
from concurrent.futures import ThreadPoolExecutor

import pytest

from test_torch_prefix import (PAGE, one_torch_thread, serve,  # noqa: F401
                               session_workload, smoke_cfg)

HOST = 64 * PAGE


def parity_run(side, spill_dtype):
    cfg = smoke_cfg(side, max_seq_len=1024)
    reqs = session_workload(side, cfg, sessions=2, turns=4, utter=220,
                            out=4)
    for r in reqs:
        r.arrival = 0.0
    return serve(side, cfg, reqs, pool_tokens=10 * PAGE,
                 session_ttl=1000.0, host_pool_tokens=HOST,
                 spill_dtype=spill_dtype)


@pytest.mark.parametrize("spill_dtype", ["bf16", "int4"])
def test_spill_parity_with_jax_engine(spill_dtype):
    with ThreadPoolExecutor(2) as ex:
        futs = {side: ex.submit(parity_run, side, spill_dtype)
                for side in ("jax", "torch")}
        j, t = futs["jax"].result(), futs["torch"].result()
    assert t.dispatched == j.dispatched
    for key in ("spilled_pages", "restored_pages", "restored_tokens",
                "spill_hold_events", "session_lookups", "session_hits",
                "prefill_tokens_skipped", "spilled_bytes",
                "restored_bytes"):
        assert getattr(t.res, key) == getattr(j.res, key) > 0, key
    for key in ("spill_drops", "session_hit_tokens", "prefix_hit_tokens"):
        assert getattr(t.res, key) == getattr(j.res, key), key
    assert t.res.restore_time_total == pytest.approx(j.res.restore_time_total)
    assert t.outs == j.outs and t.prompts == j.prompts
    if spill_dtype == "int4":
        cfg = smoke_cfg("torch", max_seq_len=1024)
        hot = t.res.spilled_pages * PAGE * cfg.cache_bytes_per_token()
        assert t.res.spilled_bytes < hot / 2
