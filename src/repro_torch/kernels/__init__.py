"""Kernels: the attention kernels and the RWKV6 recurrence, hand-written
in CUDA for Hopper (``csrc/``), their ``ctypes`` wrappers, plain PyTorch
versions (``ref.py``) and the device-based dispatch (``ops.py``)."""
