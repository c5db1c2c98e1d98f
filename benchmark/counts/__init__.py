"""Work counted from shapes and from what the inputs need, the same
whatever implementation computes it, and the chip's peaks that turn it
into the least time the work could take.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity):
matrix-shaped operations at the tensor-core rate of their operand type
(f32 operands at the TF32 rate, bf16 at the bf16 rate), other arithmetic
at the f32 rate outside the tensor cores, bytes at the HBM3 bandwidth,
each input read once and each output written once.  A count of 3xTF32
passes counts an implementation, so it is not made here.
"""
from dataclasses import dataclass

PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def tensor_peak(dtype_name):
    return PEAK_BF16_FLOPS if dtype_name in ('bfloat16', 'float16') \
        else PEAK_TF32_FLOPS


@dataclass
class Work:
    """Operations on the tensor cores (by peak), other f32 operations and
    bytes of one piece of work."""
    tensor_flops: float = 0.0
    tensor_rate: float = PEAK_TF32_FLOPS
    flops: float = 0.0
    bytes: float = 0.0

    def bound_s(self):
        """The least time: the larger of the operations' time (the larger
        of the tensor-core and the f32 time) and the bytes' time."""
        t_ops = max(self.flops / PEAK_F32_FLOPS,
                    self.tensor_flops / self.tensor_rate)
        return max(t_ops, self.bytes / PEAK_BYTES)

    def scaled(self, k):
        return Work(self.tensor_flops * k, self.tensor_rate, self.flops * k,
                    self.bytes * k)


def total_bound_s(works):
    """The least time of a sequence of pieces of work, each bounded on its
    own."""
    return sum(w.bound_s() for w in works)
