"""Density-bitfield packing in linear (x, y, z) voxel order (port of
``packbits`` / ``unpackbits`` of ``ssdnerf_tpu/ops/morton.py``): bit i of
byte b is grid element ``8 * b + i``."""
import torch


def _bit_weights(device):
    return torch.tensor([1 << i for i in range(8)], dtype=torch.int32,
                        device=device)


def packbits(grid, thresh):
    """(..., N) float grid -> (..., N // 8) uint8 bitfield of ``grid >
    thresh``."""
    occ = (grid > thresh).to(torch.int32).reshape(grid.shape[:-1] + (-1, 8))
    return (occ * _bit_weights(grid.device)).sum(-1).to(torch.uint8)


def unpackbits(bitfield):
    """(..., N // 8) uint8 -> (..., N) bool occupancy."""
    bits = (bitfield[..., None].to(torch.int32)
            >> torch.arange(8, device=bitfield.device, dtype=torch.int32)) & 1
    return bits.reshape(bitfield.shape[:-1] + (-1,)).bool()
