"""Attention kernels: hand-written CUDA for Hopper (``csrc/``), their
``ctypes`` wrappers, plain PyTorch versions (``ref.py``) and the
device-based dispatch (``ops.py``)."""
