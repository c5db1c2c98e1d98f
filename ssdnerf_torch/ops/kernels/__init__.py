"""Hand-written CUDA kernels for Hopper (sources in ``ssdnerf_torch/csrc``).

Each wrapper takes its plain PyTorch version for CPU tensors, launches its
kernel for CUDA tensors (or raises), and counts its launches in
``<wrapper>.launches``.
"""
