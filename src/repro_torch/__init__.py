"""PyTorch/CUDA port of the Chameleon many-adapter serving system.

A second package beside the JAX reference ``repro``: the control plane
(``core``, ``serving.handles``, ``serving.metrics``, ``configs``,
``models.base``) is a verbatim copy of the reference's framework-free
modules; the data plane (``models``, ``kernels``, ``serving.engine``) and
the training substrate (``training``) run on PyTorch, with the reference's Pallas TPU kernels replaced by
hand-written CUDA kernels for Hopper (``csrc/``). Nothing here imports
JAX or the ``repro`` package.

Entry points run on the CUDA device by default and raise when there is
none; pass ``device="cpu"`` to run on the CPU.
"""
