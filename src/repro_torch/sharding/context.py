"""Process-wide mesh context.

PyTorch counterpart of ``repro/sharding/context.py``.  Launchers
register the active mesh here (``set_mesh``); the model's entry points
read it when they are not handed a mesh (``get_mesh``).  ``None`` (the
default) is the single-device path.

The reference's ``pin``, ``pin_residual`` and ``pin_heads`` are GSPMD
layout hints (``with_sharding_constraint``) that keep XLA's propagation
from choosing a bad layout.  They have no counterpart: the port is
explicit SPMD, each rank holds its shard as a local tensor and the model
code issues every collective itself, so every layout is fixed by the
code.
"""
from __future__ import annotations

_CTX = {"mesh": None}


def set_mesh(mesh) -> None:
    _CTX["mesh"] = mesh


def get_mesh():
    return _CTX["mesh"]
