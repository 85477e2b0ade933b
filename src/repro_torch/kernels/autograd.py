"""The hand-written kernels under autograd: the forward on the kernel, the
backward through the plain version.

Training runs the model's ``forward`` with gradients on.  On the card,
``flash_prefill`` and ``wkv6`` are hand-written CUDA kernels with no
backward; ``kernels/ops.py`` sends a call whose inputs require a gradient
(with grad mode on) through a :class:`KernelFunction` instead:

* ``forward`` launches the CUDA kernel, the same launch serving makes
  (counted in ``runtime.launch_counts`` by its wrapper), and saves only
  its inputs;
* ``backward`` re-runs the plain version (``ref.flash_prefill_ref``,
  ``ref.wkv6_ref``) on those inputs under ``torch.enable_grad()`` and
  returns ``torch.autograd.grad`` of it, counted in
  ``runtime.autograd_counts``.

That is the reference's own gradient: it trains through its jnp
attention and ``wkv_scan`` (its Pallas wrappers are for inference, and
no backward Pallas kernel exists to port), and the plain versions are
that math.  The forward on the card stays the hand-written kernel: there
is no switch and no quiet swap; a failed build or launch raises as in
serving.  A hand-written backward kernel is later speed work.

:class:`KernelFunction` is generic over (forward, plain): a test on the
CPU builds one with the plain version as its forward.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import runtime


class KernelFunction:
    """``forward`` and its ``plain`` version, two functions of the same
    positional tensors (None allowed) and keyword options, each returning
    a tensor or a tuple of tensors.  Calling it runs ``forward`` under
    autograd with the gradient of ``plain``."""

    def __init__(self, name: str, forward: Callable, plain: Callable):
        self.name, self.forward, self.plain = name, forward, plain

    def __call__(self, *tensors, **options):
        return _Apply.apply(self, options, *tensors)


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn: KernelFunction, options: dict, *tensors):
        ctx.fn, ctx.options = fn, options
        ctx.save_for_backward(*tensors)
        out = fn.forward(*tensors, **options)
        ctx.n_out = len(out) if isinstance(out, tuple) else 0
        return out

    @staticmethod
    def backward(ctx, *grads):
        fn = ctx.fn
        needs = ctx.needs_input_grad[2:]
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
