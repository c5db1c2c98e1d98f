"""The triplane decode's work per sample point (``chip_smoke.py``'s
arithmetic): the 4-tap bilinear samples of 3 planes x C channels, the base
Linear (a product on the tensor cores), SiLU and the density head; colour
adds the direction branch's add, a second SiLU and the 3-wide head."""
from . import PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, Work


def point_flops(C, hidden, colour=True):
    """f32 operations of one point outside the base product."""
    ops = 27 * C + hidden + 4 * hidden + 2 * hidden
    return ops + (hidden + 4 * hidden + 6 * hidden if colour else 0)


def point_products(C, hidden):
    """Operations of one point's base product (2 a MAC)."""
    return 2 * 3 * C * hidden


def forward(points, rays, C, hidden, res, bf16, colour=True):
    """Work of a forward decode of ``points`` samples of ``rays`` rays:
    the planes read once, each point's position (and ray id) read and its
    outputs written, the rays' direction-branch outputs read once."""
    el = 2 if bf16 else 4
    per_point = 12 + (4 + 16 if colour else 4)
    moved = 3 * res * res * C * el + points * per_point
    if colour:
        moved += rays * hidden * 4
    return Work(tensor_flops=points * point_products(C, hidden),
                tensor_rate=PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS,
                flops=points * point_flops(C, hidden, colour),
                bytes=moved)


def backward(points, rays, C, hidden, res, bf16):
    """Work of the decode's backward: three products a point (base
    gradient, weight gradient, feature gradient), the forward's other
    arithmetic twice; the planes read and their gradient written, each
    point's inputs and upstream gradients read."""
    el = 2 if bf16 else 4
    moved = 2 * 3 * res * res * C * el + points * (12 + 4 + 16) \
        + 2 * rays * hidden * 4
    return Work(tensor_flops=3 * points * point_products(C, hidden),
                tensor_rate=PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS,
                flops=2 * points * point_flops(C, hidden),
                bytes=moved)
