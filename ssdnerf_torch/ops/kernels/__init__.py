"""Hand-written CUDA kernels for Hopper (sources in ``ssdnerf_torch/csrc``).

Each wrapper takes its plain PyTorch version for CPU tensors, launches its
kernel for CUDA tensors (or raises), and counts its launches in
``<wrapper>.launches`` (f32 operands) or ``<wrapper>.launches_bf16`` (bf16
operands, for the kernels that have both modes).
"""
from . import attention, decode, march

# each kernel's wrapper and the attribute its launches are counted in
WRAPPERS = {'march': (march.occupancy_lookup, 'launches'),
            'march_popcount': (march.occupied_counts, 'launches'),
            'decode': (decode.triplane_decode, 'launches'),
            'decode_bwd': (decode.triplane_decode_backward, 'launches'),
            'decode_composite': (decode.triplane_decode_composite,
                                 'launches'),
            'decode_banded': (decode.triplane_decode_banded, 'launches'),
            'decode_bf16': (decode.triplane_decode, 'launches_bf16'),
            'decode_bwd_bf16': (decode.triplane_decode_backward,
                                'launches_bf16'),
            'decode_composite_bf16': (decode.triplane_decode_composite,
                                      'launches_bf16'),
            'decode_banded_bf16': (decode.triplane_decode_banded,
                                   'launches_bf16'),
            'attention': (attention.attention, 'launches'),
            'attention_bwd': (attention.attention_backward, 'launches'),
            'attention_bf16': (attention.attention, 'launches_bf16'),
            'attention_bwd_bf16': (attention.attention_backward,
                                   'launches_bf16')}


def launch_counts():
    """Each kernel's launches in this process so far, by name."""
    return {n: getattr(w, attr) for n, (w, attr) in WRAPPERS.items()}


def reset_launches():
    for wrapper, attr in WRAPPERS.values():
        setattr(wrapper, attr, 0)
