"""BucketServe in PyTorch on one NVIDIA H100.

The package mirrors the JAX reference package ``repro`` path for path
(``configs/``, ``core/``, ``data/``, ``models/``, ``kernels/``,
``launch/``), so each module's counterpart is found by its path.  It
imports ``torch`` and numpy only: nothing of JAX, nothing of ``repro``.
The scheduler, batcher, serving loop and paging modules are copies of
the reference's JAX-free modules with rewritten imports; the model,
kernel and engine modules are rewritten in PyTorch idiom.

Design notes:

* **Device.** Entry points (``ServingEngine``, ``TorchEngineBackend``,
  ``models.transformer.init_params``, ``launch/serve.py``) default to
  ``device="cuda"`` and raise when no card is present.  The tests pass
  ``device="cpu"`` explicitly; nothing falls back silently.
* **Kernels.** Attention runs through ``kernels/ops.py``.  A tensor on
  the CPU goes to the plain PyTorch version in ``kernels/ref.py``; a
  tensor on the card goes to a hand-written CUDA kernel
  (``csrc/*.cu``, built by ``nvcc`` for ``sm_90a`` into one shared
  library under ``build/kernels/`` and bound with ``ctypes``), or the
  wrapper raises.  Each wrapper counts its launches.
* **Caches.** Cache pytrees keep the reference layout
  ``{"pos", "block_tables", "groups"}`` with a leading ``reps`` axis
  per block group, so the engine's gather/scatter code ports line for
  line.  Unlike JAX's functional ``.at[].set``, pools are preallocated
  once and updated in place.
* **Index semantics.** JAX drops out-of-range scatters and clamps
  out-of-range gathers; torch raises (or corrupts memory on CUDA).  The
  port masks the contiguous decode write of a dead slot whose position
  ran past the cache and clips the gathers the reference lets JAX clamp.
"""
