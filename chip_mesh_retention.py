"""The engine's session and spill runs at full depth, with and without
the one-rank mesh, on one CUDA card.

``chip_smoke.py`` serves the retention phase's 4 sessions x 3 turns and
its 48-page spill run through ``ServingEngine(mesh=...)`` on 10 of
Qwen3-14B's 40 layers, to keep the script short.  This script serves
the same two runs on all 40 layers (full width, bf16, random weights
from a seeded generator, eager, every first turn at t = 0), first
without a mesh and then under the (1, 1) NCCL mesh, with
``chip_smoke``'s gates (ids equal both ways, the session run's formed
batches too, hits, pages spilled and restored, one kernel launch a
layer a chunk or step, every page and host slot back after ``clear``).
For each run it prints the later-turn TTFT p50, the restore holds and
the preemptions, and every later turn's TTFT with the phases its
latency ledger charged it (queue, admission block, requeue gap,
restore hold, prefill, ...): where a long later-turn TTFT waited.

    python chip_mesh_retention.py

Needs one card and exits non-zero without one.  Its last line is a JSON
object of both runs each way.
"""
import dataclasses
import gc
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_mesh_retention.py needs a CUDA card", file=sys.stderr)
        return 1
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.serve import default_pool_tokens
    from repro_torch.sharding import partition

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.log("env", f"{smi}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    runtime.library()
    cs.log("build", f"kernels built in {time.perf_counter() - t0:.1f} s")
    cfg = dataclasses.replace(get_config("qwen3-14b"), max_seq_len=4096)
    model, wbytes = cs.make_model(torch, "qwen3-14b", cfg)
    warm = cs.make_engine(torch, cfg, model, wbytes, True, 2,
                          2 * cfg.max_seq_len, decode_graph=False)
    cs.serve_run(torch, cfg, warm, cs.requests([96, 700], 4), "warm-up")
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    pool_tokens = default_pool_tokens(cfg, model, torch.device("cuda"))
    want = cs.mesh_retention_runs(torch, cfg, model, wbytes, pool_tokens)
    with tempfile.TemporaryDirectory() as d:
        mesh_mod.init_distributed(1, 1, "cuda", rank=0, world_size=1,
                                  init_method=f"file://{d}/store")
        try:
            mesh = mesh_mod.make_host_mesh(1, 1)
            partition.shard_model(cfg, model, mesh)
            got = cs.mesh_retention_runs(torch, cfg, model, wbytes,
                                         pool_tokens, mesh)
        finally:
            dist.destroy_process_group()
    cs.mesh_retention_compare(want, got)
    keep = ("stats", "steps", "ttft_later", "turns", "hits", "spilled",
            "holds", "preemptions", "layers")
    out = {who: {name: {k: run[name][k] for k in keep} for name in run}
           for who, run in (("no mesh", want), ("(1, 1) mesh", got))}
    cs.log("done", f"{time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
