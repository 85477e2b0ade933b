"""Op-level analysis: roofline terms from a traced step.

PyTorch counterpart of ``repro/launch/hlo_analysis.py``.  The reference
parses the optimized HLO of a compiled dry-run; the port has no HLO, so
it counts the PyTorch ops a step dispatches, under a
``TorchDispatchMode`` (:class:`OpCount`), on real tensors or on fake
ones (``FakeTensorMode``: shapes only, nothing allocated):

* FLOPs: ``torch.utils.flop_counter``'s registry (the matrix products,
  convolutions and attention ops), with ``aten._grouped_mm`` added
  (``2 M K N`` over its rows, as the reference divides ``ragged_dot``'s
  dense count by E);
* HBM bytes: the input and output bytes of every op that materialises
  its result.  Views and metadata ops count zero; an in-place write
  (``copy_``, ``index_put_``, ``scatter_``, ``index_copy_``, ...) counts
  twice the written slice, as the reference's in-place rule; a gather
  (``index``, ``index_select``, ``embedding``, ...) reads its slice and
  writes it, not the whole table; a broadcast operand counts its
  distinct elements.  An eager dtype cast is a kernel on the card and
  counts (the reference skips XLA:CPU's ``convert``);
* collective bytes per the reference's five kinds, from the ``c10d``
  ops (the output's bytes, as the reference takes the instruction's
  shape).

All numbers are per rank: under a mesh each rank runs its own program,
and a trace on the fake process group (``launch/dryrun.py``) is rank 0's.

The hand-written kernels and the grouped product are counted by formula
(``kernels/cost.py``), the counterpart of the reference's
``vmem_fused:`` and ``grouped_mm:`` scopes.  ``count(fn, *args,
fused_kernels=True)`` counts the deployment: each kernel call adds its
formula, and nothing inside it is counted (its output allocation, plan
buffers and offset scalar belong to the kernel), so the real and the
fake trace of a step count the same ops; on fake tensors the call
returns an empty output and reaches neither the kernel nor its plain
version.  ``fused_kernels=False`` runs the plain versions op by op, as
the reference's unfused count does; the grouped product counts by
formula in both.  On real tensors a kernel call under a count is the
entry's own call: the kernel launches, its ops unseen, and a backward
that autograd records runs after it: op by op for ``flash_prefill``'s
plain backward, by its formula for ``wkv6``'s backward kernel
(``kernels/ops.py:wkv6_bwd``, a scope of its own).  On fake tensors a
call that autograd records takes the card's route: the kernel's forward
by formula, then ``flash_prefill``'s plain backward op by op and
``wkv6``'s backward kernel by formula (``kernels/autograd.py``); the
grouped product's backward is its two grouped products.  An unfused count refuses real tensors on the card,
where the plain version would take a kernel's place.

The count also records three memory sizes: the argument bytes (the
storages of ``fn``'s arguments: this rank's parameters, optimizer state,
inputs and cache), the output bytes (and the part of them that aliases
an argument) and the peak of the bytes allocated during the trace and
still live, the counterpart of ``memory_analysis().temp_size_in_bytes``.

``RooflineTerms`` sets a count against one H100's peaks
(``core/hardware.py:H100``: 989e12 dense bf16 FLOP/s, 3.35e12 B/s of
HBM) and one link a card for the collectives: ``LINK_BW`` is one 400
Gb/s NDR InfiniBand port, 50e9 B/s (NVIDIA DGX H100 system: eight
ConnectX-7 ports of 400 Gb/s for eight cards), because a 16-rank axis
spans two 8-card nodes; NVLink's 450e9 B/s each way holds only inside a
node.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.hardware import H100

PEAK_FLOPS = H100.peak_flops    # dense bf16, one H100 SXM
HBM_BW = H100.hbm_bw
LINK_BW = 50e9                  # one 400 Gb/s NDR port a card

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten


def _grouped_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs):
    """``aten._grouped_mm``: each output element is a K-long dot; two 2-D
    operands (the weight gradient, (K, M) by (M, N) grouped over M) make
    each of the M contraction rows count in one group only."""
    if len(a_shape) == 2 and len(b_shape) == 2:
        return 2 * a_shape[0] * a_shape[1] * b_shape[1]
    n = 1
    for s in out_shape:
        n *= s
    return 2 * n * a_shape[-1]


FLOP_REGISTRY = dict(flop_counter.flop_registry)
FLOP_REGISTRY[aten._grouped_mm] = flop_counter.shape_wrapper(
    _grouped_mm_flop)

# queries of a tensor's metadata: no op runs
_META = {aten.sym_size, aten.sym_stride, aten.sym_numel,
         aten.sym_storage_offset, aten.size, aten.stride, aten.numel,
         aten.dim, aten.storage_offset, aten.is_contiguous,
         aten.is_strides_like_format, aten.is_non_overlapping_and_dense,
         aten.sym_is_contiguous, torch.ops.prim.device}
# allocations that write nothing, and views the schema does not mark
_ZERO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "lift_fresh_copy",
               "alias", "detach", "set_", "resize_", "_local_scalar_dense",
               "view", "_unsafe_view", "t", "transpose", "permute",
               "expand", "slice", "select", "unsqueeze", "squeeze",
               "as_strided", "split", "split_with_sizes", "unbind",
               "chunk", "narrow", "diagonal", "unfold", "view_as_real",
               "view_as_complex", "_reshape_alias", "unsafe_split"}
# in-place writes of a slice: twice the written slice
_SLICE_WRITES = {"copy_", "index_put_", "_index_put_impl_", "scatter_",
                 "scatter_add_", "scatter_reduce_", "index_copy_",
                 "index_add_"}
# reads of a slice of a table: the slice read and written, the indices read
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
# c10d op -> (kind, whether its first argument is written in place from a
# separate input at its second)
_C10D = {"allreduce_": ("all-reduce", False),
         "allreduce_coalesced_": ("all-reduce", False),
         "allgather_": ("all-gather", True),
         "_allgather_base_": ("all-gather", True),
         "allgather_into_tensor_coalesced_": ("all-gather", True),
         "reduce_scatter_": ("reduce-scatter", True),
         "_reduce_scatter_base_": ("reduce-scatter", True),
         "reduce_scatter_tensor_coalesced_": ("reduce-scatter", True),
         "alltoall_": ("all-to-all", True),
         "alltoall_base_": ("all-to-all", True),
         "send": ("collective-permute", False),
         "recv_": ("collective-permute", False)}


def _tensors(tree):
    """The tensors of a tree of dicts, lists, tuples and modules."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` reads: a broadcast dim
    (stride 0) counts once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def _bytes(tree) -> int:
    return sum(_distinct_bytes(t) for t in _tensors(tree))


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _storages(tree) -> Dict[int, int]:
    """{storage key: storage bytes} of a tree's tensors."""
    return {_storage_key(t): t.untyped_storage().nbytes()
            for t in _tensors(tree)}


def _indexed_elements(self_t, indices) -> int:
    """Elements ``self_t[indices]`` selects (a boolean mask: all of it)."""
    shapes = [i.shape for i in indices if i is not None]
    n = 1
    for s in torch.broadcast_shapes(*shapes) if shapes else ():
        n *= s
    for d, size in enumerate(self_t.shape):
        if d >= len(indices) or indices[d] is None:
            n *= size
    return n


def op_bytes(func, args, kwargs, out) -> int:
    """HBM bytes of one op (module docstring)."""
    name = func._opname
    if func.is_view or name in _ZERO_BYTES:
        return 0
    if name in _SLICE_WRITES:
        dst = args[0]
        if name == "copy_":
            n = dst.numel()
        elif name in ("index_put_", "_index_put_impl_"):
            n = _indexed_elements(dst, args[1])
        elif name.startswith("scatter"):
            n = args[2].numel()
        else:                                   # index_copy_, index_add_
            n = args[3].numel()
        return 2 * n * dst.element_size()
    if name in _GATHERS:
        index_bytes = sum(_distinct_bytes(a) for a in _tensors(args[1:])
                          if not a.is_floating_point())
        return 2 * _bytes(out) + index_bytes
    return _bytes((args, kwargs)) + _bytes(out)


@dataclasses.dataclass
class ModuleStats:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})

    def __iadd__(self, o: "ModuleStats"):
        self.flops += o.flops
        self.bytes += o.bytes
        for k in self.coll:
            self.coll[k] += o.coll[k]
        return self


@dataclasses.dataclass
class Count:
    """What one traced call counted: ``stats`` (FLOPs, HBM bytes,
    collective bytes by kind), the ops outside kernel scopes by name
    (``ops``) with their FLOPs and bytes (``op_stats``), the kernel calls
    by name (``kernels``) with their formulas' FLOPs and bytes
    (``kernel_stats``), the memory sizes (``memory``) and the call's
    result (``result``)."""
    stats: ModuleStats
    ops: collections.Counter
    op_stats: Dict[str, ModuleStats]
    kernels: collections.Counter
    kernel_stats: Dict[str, ModuleStats]
    memory: Dict[str, int]
    result: object = None


class OpCount(TorchDispatchMode):
    """The counting mode (module docstring).  ``kernel_call`` is the
    hook of ``kernels/cost.py:scope``."""

    def __init__(self, fused_kernels: bool = True, context=None):
        super().__init__()
        self.fused = fused_kernels
        self.context = context
        self.ops = collections.Counter()
        self.op_stats: Dict[str, ModuleStats] = {}
        self.kernels = collections.Counter()
        self.kernel_stats: Dict[str, ModuleStats] = {}
        self._quiet = 0
        self._live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    # ------------------------------------------------------------ memory
    def track(self, out, known=()) -> None:
        """Add each storage of ``out`` not in ``known`` nor already live
        to the live bytes, until its tensor is freed."""
        for t in _tensors(out):
            key = _storage_key(t)
            if key in known or key in self._seen:
                continue
            n = t.untyped_storage().nbytes()
            self._seen[key] = n
            self._live += n
            self.peak = max(self.peak, self._live)
            weakref.finalize(t, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._seen.pop(key, 0)

    # ------------------------------------------------------------ kernels
    def kernel_call(self, name, formula, entry, plain, like, args, kwargs,
                    *, always=False):
        """A kernel entry's call under this count (``cost.scope``)."""
        from torch._subclasses.fake_tensor import FakeTensor
        inputs = list(_tensors((args, kwargs)))
        fake = any(isinstance(t, FakeTensor) for t in inputs)
        if not (self.fused or always):
            if not fake and any(t.device.type != "cpu" for t in inputs):
                raise ValueError(
                    f"op_analysis: an unfused count runs {name}'s plain "
                    f"version, which takes the kernel's place only on fake "
                    f"or CPU tensors; count real device tensors with "
                    f"fused_kernels=True")
            return plain(*args, **kwargs)
        c = formula(*args, context=self.context, **kwargs)
        self.kernels[name] += 1
        ks = self.kernel_stats.setdefault(name, ModuleStats())
        ks.flops += c.flops
        ks.bytes += c.bytes
        self._quiet += 1
        try:
            out = (like if fake else entry)(*args, **kwargs)
        finally:
            self._quiet -= 1
        self.track(out, {_storage_key(t) for t in inputs})
        return out

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._quiet or func._overloadpacket in _META:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == "aten" and packet not in FLOP_REGISTRY:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        name = f"{func.namespace}.{func._opname}"
        self.ops[name] += 1
        st = self.op_stats.setdefault(name, ModuleStats())
        if func.namespace in ("c10d", "_c10d_functional"):
            self._collective(func, args, st)
        else:
            if packet in FLOP_REGISTRY:
                st.flops += FLOP_REGISTRY[packet](*args, **kwargs,
                                                  out_val=out)
            st.bytes += op_bytes(func, args, kwargs, out)
        self.track(out, {_storage_key(t) for t in _tensors((args, kwargs))})
        return out

    def _collective(self, func, args, st: ModuleStats) -> None:
        if func._opname not in _C10D:
            raise ValueError(f"op_analysis: no collective kind for "
                             f"{func.namespace}.{func._opname}")
        kind, separate = _C10D[func._opname]
        written = _bytes(args[0])
        st.coll[kind] += written
        st.bytes += written + (_bytes(args[1]) if separate else written)

    def total(self) -> ModuleStats:
        """The ops' and the kernels' counts summed."""
        s = ModuleStats()
        for part in (*self.op_stats.values(), *self.kernel_stats.values()):
            s += part
        return s


def count(fn, *args, fused_kernels: bool = True, context=None,
          **kw) -> Count:
    """Run ``fn(*args, **kw)`` under an :class:`OpCount` and return what
    it counted (the counterpart of ``hlo_analysis.module_stats``; run it
    under ``FakeTensorMode`` with fake arguments for a count without
    allocation).  ``context``: the live keys a row of each attention
    kernel call, an int or B ints from the caller's host state (a decode
    at position p has p + 1), which the tensors hold only on the device;
    None counts each call's whole span (``kernels/cost.py``).  An
    unfused count takes fake or CPU tensors: on the card each kernel
    launches and counts by its formula."""
    arg_storages = _storages((args, kw))
    mode = OpCount(fused_kernels, context)
    with mode:
        result = fn(*args, **kw)
    out_storages = _storages(result)
    alias = {k: n for k, n in out_storages.items() if k in arg_storages}
    memory = {"argument_bytes": sum(arg_storages.values()),
              "output_bytes": sum(out_storages.values()),
              "alias_bytes": sum(alias.values()),
              "temp_bytes": mode.peak}
    return Count(mode.total(), mode.ops, mode.op_stats, mode.kernels,
                 mode.kernel_stats, memory, result)


@dataclasses.dataclass
class RooflineTerms:
    """All per rank: a traced step is one rank's program."""
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    n_devices: int
    model_flops: float           # global useful flops (6ND / 2ND)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.flops_per_device
                                      * self.n_devices, 1.0)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "n_devices": self.n_devices, "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
        }


def analyze(c: Count, n_devices: int, model_flops: float) -> RooflineTerms:
    return RooflineTerms(
        flops_per_device=c.stats.flops,
        bytes_per_device=c.stats.bytes,
        coll_bytes_per_device=sum(c.stats.coll.values()),
        n_devices=n_devices,
        model_flops=model_flops,
    )
