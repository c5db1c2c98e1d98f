"""The numbers the checks compare, each a worst case over what it covers."""
import math
import statistics

import torch


def leaf_norms(tensors):
    """{name: L2 norm} (f64) of a dict of tensors."""
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def worst_norm_gap(got, ref, keep=None):
    """The largest |‖got‖ - ‖ref‖| over the leaves (names of ``ref``, or
    of ``keep``), against the larger of the leaf's reference norm and the
    median leaf's; and that leaf's name."""
    names = [k for k in ref if keep is None or k in keep]
    median = statistics.median(ref[k] for k in names)
    worst, at = 0.0, None
    for k in names:
        gap = abs(got[k] - ref[k]) / max(ref[k], median, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, at = gap, k
    return worst, at


def rel_l2(got, ref):
    """‖got - ref‖ / ‖ref‖ in f64."""
    got, ref = got.detach().double(), ref.detach().double()
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref).clamp_min(1e-300))


def rel_gap(got, ref):
    """|got - ref| / |ref| of two numbers."""
    return abs(float(got) - float(ref)) / max(abs(float(ref)), 1e-30)


def bit_flips(a, b):
    """Share of bits that differ between two uint8 bitfields."""
    x = torch.bitwise_xor(a.to(torch.uint8), b.to(torch.uint8))
    table = torch.tensor([bin(i).count('1') for i in range(256)],
                         dtype=torch.int64, device=x.device)
    return float(table[x.long()].sum()) / (8 * x.numel())
