"""The hand-written kernels under autograd.

Training runs the model's ``forward`` with gradients on.  On the card,
``flash_prefill`` and ``wkv6`` are hand-written CUDA kernels;
``kernels/ops.py`` sends a call whose inputs require a gradient (with
grad mode on) through a :class:`KernelFunction` instead:

* ``forward`` launches the CUDA kernel, the same launch serving makes
  (counted in ``runtime.launch_counts`` by its wrapper), and saves only
  its inputs;
* with a ``backward`` entry (``wkv6``: ``ops.wkv6_bwd``, the
  hand-written backward kernel ``csrc/wkv6_bwd.cu`` on the card),
  ``backward`` calls it on the saved inputs and the incoming gradients
  of the outputs (None for an output whose gradient is not needed) and
  returns its gradients, None for an input that needs none; the entry's
  wrapper counts its launch in ``runtime.launch_counts``;
* without one (``flash_prefill``), ``backward`` re-runs the plain
  version (``ref.flash_prefill_ref``) on the saved inputs under
  ``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it,
  counted in ``runtime.autograd_counts``.

That is the reference's own gradient: it trains through its jnp
attention and ``wkv_scan`` (its Pallas wrappers are for inference, and
no backward Pallas kernel exists to port); the plain versions are that
math, and ``wkv6``'s backward kernel is its closed-form reverse
recurrence (``ref.wkv6_bwd_ref``).  There is no switch and no quiet
swap; a failed build or launch raises as in serving.  A hand-written
attention backward is later work.

:class:`KernelFunction` is generic over its forward and its gradient
(a ``plain`` version or a ``backward`` entry): a test on the CPU builds
one with the plain version as its forward, and ``wkv6``'s forward picks
the kernel or the plain version by the operands' device.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import runtime


class KernelFunction:
    """``forward`` with one of ``plain``, a function of the same
    positional tensors (None allowed) and keyword options, each returning
    a tensor or a tuple of tensors, or ``backward``, a function of the
    positional tensors, then one incoming gradient an output (None
    allowed), returning one gradient a positional tensor (the keyword
    options are the forward's alone).  Calling it runs ``forward`` under
    autograd with the gradient of ``plain``, or ``backward``'s."""

    def __init__(self, name: str, forward: Callable,
                 plain: Optional[Callable] = None, *,
                 backward: Optional[Callable] = None):
        if (plain is None) == (backward is None):
            raise ValueError(f"{name}: give a plain version or a backward "
                             f"entry, not both or neither")
        self.name, self.forward, self.plain = name, forward, plain
        self.backward = backward

    def __call__(self, *tensors, **options):
        return _Apply.apply(self, options, *tensors)


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn: KernelFunction, options: dict, *tensors):
        ctx.fn, ctx.options = fn, options
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)    # an unused output: None
        out = fn.forward(*tensors, **options)
        ctx.n_out = len(out) if isinstance(out, tuple) else 0
        return out

    @staticmethod
    def backward(ctx, *grads):
        fn = ctx.fn
        needs = ctx.needs_input_grad[2:]
        if fn.backward is not None:
            got = fn.backward(*ctx.saved_tensors, *grads)
            return (None, None) + tuple(g if need else None
                                        for g, need in zip(got, needs))
        inputs = [t.detach().requires_grad_(need) if need else t
                  for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = fn.plain(*inputs, **ctx.options)
        runtime.autograd_counts[fn.name] = \
            runtime.autograd_counts.get(fn.name, 0) + 1
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x, need in zip(inputs, needs) if need]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wrt))
        return (None, None) + tuple(next(got) if need else None
                                    for need in needs)


def needs_grad(*tensors) -> bool:
    """Whether a call on these tensors is recorded by autograd."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
