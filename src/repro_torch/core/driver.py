"""The engine under a mesh: one driver rank runs the serving loop and
sends each device call to every rank.

The reference serves under a mesh from one controller: its jitted
prefill, chunk and decode steps run on sharded params and GSPMD moves
the data (``repro/launch/serve.py``).  The port is explicit SPMD, one
process a device, so the controller is rank 0 of the run: it alone holds
the scheduler, the block allocator, the retention layer and the loop's
clock, and every backend method that writes device memory splits into a
host half (the decision, on rank 0) and a device half (a function of
explicit arguments, ``TorchEngineBackend._d_<op>``).  Rank 0 broadcasts
each device half's name and arguments — small ints, lists and int32
arrays: token ids, lengths, slot and row lists, block-table rows, page
ids, host slots, a chunk's start — then runs it itself; every other rank
runs :func:`serve_worker`, which receives each command and runs the same
device half on its own shards.  The ranks thus issue the same
collectives in the same order, and a worker's host state (the job's
token ids, the block tables it holds, the spill tier's staged pages) is
rebuilt from the commands alone, never from its own clock.  Ranks that
each ran the copied loop would form different batches: the loop admits
on the wall clock and the spill copier completes on device events.

The commands travel over a gloo group of their own (``CommandChannel``),
on the host, whatever the data plane is (NCCL on the card): no control
value forces a device sync.  The group's timeout is seconds, not gloo's
30 minutes, so a worker left waiting by a driver that died ends the run
with an error; a rank that raises ends its process non-zero, which the
launcher's spawn (or ``torchrun``) turns into the run's failure.
"""
from __future__ import annotations

import time
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

# seconds a rank waits on a command (or the driver on a broadcast)
# before the run fails
TIMEOUT = 120.0


class CommandChannel:
    """Rank 0's commands to every rank of the default group, broadcast
    over a gloo group made for them (``dist.new_group`` is collective:
    every rank makes the channel in the same order).  ``seconds`` and
    ``sent`` count the host time rank 0 spent broadcasting, and the
    commands, by op."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo",
                                    timeout=timedelta(seconds=TIMEOUT))
        self.rank = dist.get_rank()
        self.seconds: Dict[str, float] = {}
        self.sent: Dict[str, int] = {}

    @property
    def is_driver(self) -> bool:
        return self.rank == 0

    def send(self, op: str, args: dict) -> None:
        t0 = time.perf_counter()
        dist.broadcast_object_list([(op, args)], src=0, group=self.group)
        self.seconds[op] = self.seconds.get(op, 0.0) + \
            time.perf_counter() - t0
        self.sent[op] = self.sent.get(op, 0) + 1

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def agree_min(self, value: int) -> int:
        """The least of every rank's ``value`` (an int), on every rank."""
        t = torch.tensor([value], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return int(t)

    def host_ms(self, op: str) -> Optional[float]:
        """Mean host milliseconds of one ``op`` broadcast (None before
        the first)."""
        n = self.sent.get(op, 0)
        return self.seconds[op] * 1e3 / n if n else None

    def reset_counts(self) -> None:
        self.seconds.clear()
        self.sent.clear()


def channel(mesh) -> CommandChannel:
    """The mesh's command channel, made at the first call (on every rank:
    the engines of a run are built in the same order on every rank)."""
    ch = getattr(mesh, "_command_channel", None)
    if ch is None:
        ch = mesh._command_channel = CommandChannel()
    return ch


def serve_worker(backend) -> int:
    """A worker rank's side of a run: receive each command of the
    driver, run its device half (``backend.command``), until ``stop``;
    returns the commands run.  ``abort`` (the driver raised) raises
    here too, so every rank ends the run with an error."""
    ch = backend.channel
    n = 0
    while True:
        op, args = ch.recv()
        if op == "stop":
            return n
        if op == "abort":
            raise RuntimeError(f"rank {ch.rank}: the driver rank aborted "
                               f"the run: {args.get('reason')}")
        backend.command(op, args)
        n += 1
