"""A frozen, plain copy of the port's LTE downlink modules: the reference.

The modules under `phy/` and `_device.py` are copies of the port's files
of the same paths at commit e4337f4, each naming its origin in its first
line.  Their agreement with the JAX package rests on the port's tests at
that commit (`tests/test_torch_*.py`), which hold each copied module to its
JAX counterpart on the CPU.  `utils/jit.py` and `ops/` are plain
stand-ins: no CUDA graph, no kernel, every branch taken eagerly, the
windowed SISO and the Viterbi decoder as the port's plain PyTorch
versions.  Nothing here imports the port, JAX or the JAX package.
"""
