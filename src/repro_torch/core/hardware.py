"""The cost model's hardware constant for one NVIDIA H100 SXM (80 GB).

``core/simulator.py`` is the reference's cost model copied byte for
byte, so the card's ``HardwareSpec`` lives here.  Peaks are the card's
published figures: 989e12 dense bf16 FLOP/s and 3.35e12 B/s of HBM3,
the same that ``chip_smoke.py`` divides by for its kernels' bounds.

Topology.  One card runs prefill and decode on the same device,
interleaved (the port's engine is one ``disagg`` loop whose prefill
chunks and decode steps take turns on one stream), so
``prefill_chips = decode_chips = 1``.  The cost model's ``disagg`` mode
runs its prefill and decode executors at the same time in virtual time,
as if they had a device each: on one card it over-predicts throughput
and under-predicts TTFT and TPOT whenever both phases have work.  The
spec keeps the loop as it is and the gap is reported beside each run.

``link_bw`` is the card's own device-to-device copy rate: on one card the
"transfer" from prefill to decode is the paged insert's copy of the
batch prefill cache into the pool, not a link between devices.

``mfu`` and ``bw_eff`` are fitted on the card by ``chip_smoke.py``'s
paper phase (full-width llama2-13b, bf16):

* ``bw_eff``: the bytes a graph-mode decode step at B = 8 reads
  (weights plus live K/V) over its measured time, over 3.35e12 B/s;
* ``mfu``: the FLOPs the cost model charges for a 512-token prefill
  chunk of 8 rows at offset 1536 over the measured chunk time, over
  989e12 FLOP/s;
* ``link_bw``: the bytes of a 1 GiB device-to-device ``copy_`` over its
  time.

The script prints each fit beside the constant below.  The constants
are the fits of its run on an NVIDIA H100 80GB HBM3 at a 700 W power
limit: ``bw_eff`` 0.5437 (32.75 GB a step in 17.98 ms), ``mfu`` 0.4791
(118.65 TFLOP in 250.4 ms), ``link_bw`` 1.515e12 B/s (1 GiB in
0.709 ms).
"""
from __future__ import annotations

from .simulator import HardwareSpec

H100 = HardwareSpec("h100", peak_flops=989e12, hbm_bw=3.35e12,
                    link_bw=1.5e12, hbm_bytes=80 * 2 ** 30,
                    prefill_chips=1, decode_chips=1,
                    mfu=0.48, bw_eff=0.54)
