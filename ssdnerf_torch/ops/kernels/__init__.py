"""Hand-written CUDA kernels for Hopper (sources in ``ssdnerf_torch/csrc``).

Each wrapper takes its plain PyTorch version for CPU tensors, launches its
kernel for CUDA tensors (or raises), and counts its launches in
``<wrapper>.launches`` (f32 operands) or ``<wrapper>.launches_bf16`` (bf16
operands, for the kernels that have both modes).
"""
