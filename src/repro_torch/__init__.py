"""MSQ-Index on PyTorch and CUDA.

The batched range-query path of ``GraphQueryEngine`` over a
``FlatMSQIndex``: region bucketing, the fused q-gram filter cascade and
the stage-1.5 assignment lower bound as hand-written CUDA kernels
(``kernels/``, sources in ``csrc/``), then host A* verification.

Entry points run on the CUDA device unless the caller asks for the CPU
(``backend="torch", device="cpu"`` or ``backend="numpy"``); without a
card the default ``backend="cuda"`` raises instead of running elsewhere.

Importing the package imports neither torch nor any kernel build; the
submodules import torch where they need it.
"""
