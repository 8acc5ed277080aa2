# Hand-written CUDA kernels for Hopper (sources in ``csrc/``, built by
# nvcc at first use into build/kernels/ and bound with ctypes):
#   qgram_filter — fused MSQ filter cascade, query-batched
#   assign_lb    — batched Hausdorff branch lower bound (stage 1.5)
#
# Every kernel: kernel.py (the launch wrapper with its launch counter),
# ops.py (padding / shape buckets / host oracle), ref.py (the plain
# PyTorch version the kernel is held against; the wrapper runs it for
# CPU tensors only).
