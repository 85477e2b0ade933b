"""Where the mesh path's host time goes, on one CUDA card.

A decode step of qwen3-14b at smoke width with all 40 of its layers
(bf16, B = 8, 64 prompt tokens, a 512-slot cache) is host-bound: the
host issues its ~1250 launches more slowly than the card runs them.
This script times that step, in turns, three ways: with no mesh, under
the one-rank (1, 1) NCCL mesh (81 collectives a step: two all-reduces a
layer and the embedding's), and under the same mesh with the NCCL call
of ``sharding.collectives`` replaced by the copy it reduces into (the
wrappers and autograd Functions stay).  Then the NCCL all-reduce and the
collectives' wrappers alone in a tight loop, the all-reduce also issued
behind 40 queued 8192^2 matmuls (does it wait for the card?), and the
CPU self time of three steps each way under ``torch.profiler``.

    python chip_mesh_host.py

Prints ``STEP``, ``CALL``, ``ISSUE`` and ``PROFILE`` lines; needs one
card, and exits non-zero without one.
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))


def main() -> int:
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_mesh_host.py needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import collectives, partition

    cfg = get_smoke_config("qwen3-14b", n_layers=40, max_seq_len=512)
    model = tfm.init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")
    tok = torch.randint(0, 512, (8, 64), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    state = {}

    def as_mesh(m):
        # a (1, 1) cut leaves every leaf whole: only the model's mark differs
        if m is None:
            model.__dict__.pop("mesh_shape", None)
        else:
            model.mesh_shape = dict(m.shape)

    def setup(m):
        as_mesh(m)
        logits, cache = tfm.prefill(cfg, model, tok, cache_len=512, mesh=m)
        state[id(m)] = (logits.argmax(-1).int(), cache)

    def step_ms(m, n=30):
        as_mesh(m)
        nt, cache = state[id(m)]
        for _ in range(3):
            tfm.decode_step(cfg, model, nt, cache, mesh=m)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            tfm.decode_step(cfg, model, nt, cache, mesh=m)
        issued = (time.perf_counter() - t) / n * 1e3
        torch.cuda.synchronize()
        return issued, (time.perf_counter() - t) / n * 1e3

    setup(None)
    store = tempfile.mkdtemp()
    mesh_mod.init_distributed(1, 1, "cuda", rank=0, world_size=1,
                              init_method=f"file://{store}/store")
    mesh = mesh_mod.make_host_mesh(1, 1)
    partition.shard_model(cfg, model, mesh)
    setup(mesh)

    nccl = collectives._all_reduce

    def copy_only(x, group, op=dist.ReduceOp.SUM):
        return x.contiguous().clone()

    runs = {"no mesh": None, "mesh": mesh, "mesh, NCCL call replaced by "
            "its copy": mesh}
    res = {name: [] for name in runs}
    for _ in range(3):
        for name, m in runs.items():
            collectives._all_reduce = copy_only if "replaced" in name \
                else nccl
            res[name].append(step_ms(m))
    collectives._all_reduce = nccl
    for name, v in res.items():
        print(f"STEP {name}: host issue ms {[round(a, 3) for a, _ in v]}, "
              f"wall ms {[round(b, 3) for _, b in v]}", flush=True)

    g = mesh.group("model")
    x = torch.randn(8, 1, cfg.d_model, device="cuda", dtype=torch.bfloat16)
    calls = (("dist.all_reduce", lambda: dist.all_reduce(x, group=g)),
             ("collectives.all_reduce", lambda: collectives.all_reduce(x, g)),
             ("collectives.reduce_from", lambda: collectives.reduce_from(x, g)),
             ("collectives.copy_to", lambda: collectives.copy_to(x, g)),
             ("clone", lambda: x.clone()))
    for name, fn in calls:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        print(f"CALL {name}: {(time.perf_counter() - t) / 200 * 1e6:.1f} us "
              f"a call", flush=True)

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for name, fn in (calls[0], calls[-1]):
        for backlog in (0, 40):
            torch.cuda.synchronize()
            for _ in range(backlog):
                a @ a
            t = time.perf_counter()
            for _ in range(50):
                fn()
            issued = (time.perf_counter() - t) / 50 * 1e6
            t = time.perf_counter()
            torch.cuda.synchronize()
            print(f"ISSUE {name} behind {backlog} queued matmuls: "
                  f"{issued:.1f} us a call, then the card took "
                  f"{(time.perf_counter() - t) * 1e3:.2f} ms more", flush=True)

    for name in ("no mesh", "mesh"):
        m = runs[name]
        as_mesh(m)
        nt, cache = state[id(m)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                tfm.decode_step(cfg, model, nt, cache, mesh=m)
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)
        print(f"PROFILE {name}: 3 steps, CPU self time", flush=True)
        for e in rows[:24]:
            print(f"  {e.key[:60]:60s} n {e.count:6d} self ms "
                  f"{e.self_cpu_time_total / 1e3:9.3f}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
