"""The port's distribution over NCCL on four cards: the rank bodies of
``tests/torch_dist_ranks.py`` on a (2, 2) (data, model) mesh, one card
a rank, each sharded result against the port's own unsharded run on
the same card (the CPU twins hold the same paths against the JAX
package on 8 gloo ranks).  The engine under a mesh serves on the same
ranks: the paged pool cut by kv head on a (1, 4) mesh, a 2048-slot
contiguous pool cut along the sequence on the (2, 2) mesh, its slots
over data, the contiguous pool on (2, 2) with prefill rows cut over
data, the paged pool replicated over data on (2, 2) with session
resumes, qwen3-moe with its experts cut over data on (2, 2) and
rwkv6-3b's blocks over model on (1, 4); each run's ids (and formed
batches where formation does not follow the wall clock) against the
engine without a mesh on one card,
served in this process after the ranks end, and the replicas of the
paged pool holding the same bits (``tests/test_torch_serve_mesh.py``
holds the same cases against the JAX engine on 4 gloo ranks).  Card-only: it skips with fewer than four cards, and imports no
JAX.  Run it on a machine with four cards:

    PYTHONPATH=src python -m pytest tests/test_torch_distributed_cuda.py
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks

DATA, MODEL = 2, 2
# f32 on the cards: the kernels and the cut matmuls sum in other orders
# than the whole ones (TF32 is off: torch's default for matmuls)
TOL = dict(atol=1e-4, rtol=1e-3)
INT8_LOGIT_TOL = dict(atol=2e-3, rtol=0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if torch.cuda.device_count() < DATA * MODEL:
        pytest.skip(f"needs {DATA * MODEL} CUDA cards, one a rank (run "
                    f"this file on a machine with four)")
    from repro_torch.kernels import runtime
    runtime.library()               # built once, before the ranks load it
    d = str(tmp_path_factory.mktemp("ranks"))
    ranks.write_port_inputs(d, MODEL)
    err = ranks.spawn(d, ranks.CUDA_CASES + ranks.CUDA_ENGINE_CASES, DATA,
                      MODEL, "cuda", 600)
    torch.set_num_threads(1)
    ref = {case: ranks.port_engine_reference(d, case, device="cuda")
           for case in ranks.CUDA_ENGINE_CASES}
    return lambda name: ref[name[:-5]] if name.endswith("_port") and \
        name[:-5] in ref else ranks.load_output(d, name, err)


@pytest.mark.parametrize("name", ["forward", "kv_prefill", "kv_decode",
                                  "dd", "dd_ring", "seq"])
def test_cuda_four_card_mesh_matches_one_card(run, name):
    """The gather-path forward, the kv-head-cut prefill and decode, the
    sequence-cut decode attention and a 2048-slot sequence-cut decode
    over NCCL == the same calls unsharded on one card."""
    np.testing.assert_allclose(run(name), run(name + "_port"), **TOL)


def test_cuda_four_card_int8_sequence_cut_decode(run):
    np.testing.assert_allclose(run("seq_int8"), run("seq_int8_port"),
                               **INT8_LOGIT_TOL)


def test_cuda_four_card_cache_slice_and_ep_train_step(run):
    """The mesh's own prefill writes the kv-head slice ``shard_cache``
    cuts; the EP train step (all-to-all over data, expert d_ff over
    model) == the local step at the reference test's tolerance."""
    assert run("kv_cache_diff").max() < 1e-5
    loss_ep, loss_local = run("ep_loss")
    np.testing.assert_allclose(loss_ep, loss_local, rtol=1e-4)
    ep, local = run("ep_params"), run("ep_params_port")
    assert set(ep) == set(local)
    for k in ep:
        np.testing.assert_allclose(ep[k], local[k], atol=5e-4, rtol=5e-3,
                                   err_msg=k)


@pytest.mark.parametrize("case", ranks.CUDA_ENGINE_CASES)
def test_cuda_four_card_engine_under_a_mesh(run, case):
    """The engine under a mesh over NCCL (rank 0 driving, commands over
    gloo) == the engine without a mesh on one card: ids, and formed
    batches where every request comes at t = 0 (a session's later turns
    come when the turn before ends); a paged run gets every page back
    (after ``clear`` with retention), a pool replicated over data holds
    the same bits on every data rank, and each job whose rows data
    divides is cut over it."""
    got, want = run(case), run(case + "_port")
    _, load, (data, _), _ = ranks.ENGINE_CASES[case]
    assert got["ids"] == want["ids"]
    if load != "sessions":
        assert got["formed"] == want["formed"]
    if load == "sessions":
        free, total = got["pages_after_clear"][:2]
        assert free == total and got["counts"]["session_hits"] > 0
    elif "pages" in got:
        free, live, total = got["pages"]
        assert free == total and live == 0
    for sums in got.get("replicas", {}).values():
        assert len(sums) == data and all(x == sums[0] for x in sums)
    for B, rows in got["layout"]["jobs"]:
        assert rows == (B // data if B % data == 0 else B)
