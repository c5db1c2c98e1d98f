"""Density-bitfield packing in linear (x, y, z) voxel order (port of
``packbits`` / ``unpackbits`` of ``ssdnerf_tpu/ops/morton.py``): bit i of
byte b is grid element ``8 * b + i``; and the Morton codes of the
reference's voxel layout, which scene-cache files use
(``tools/convert_cache.py``), and their inverse."""
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


def occupancy_table(bitfield, grid_size):
    """Linear (x, y, z) bitfield -> byte table, the port of
    ``occupancy_table`` of ``ssdnerf_tpu/ops/pallas/march.py`` without its
    -128 int8 offset: (..., 2H, 4H) uint8 whose byte ``flat = y * 8H + x * 8
    + zb`` (row ``flat >> 8``, column ``flat & 255``) packs the bits z = 8 zb
    .. 8 zb + 7 of voxel column (x, y)."""
    H = grid_size
    lead = bitfield.shape[:-1]
    cols = bitfield.reshape(lead + (H, H, H // 8)).transpose(-3, -2)
    return cols.reshape(lead + (2 * H, 4 * H))


def _expand_bits(v):
    """Spread the low 10 bits of ``v`` (int64) two zero bits apart."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    return (v * 0x00000005) & 0x49249249


def morton3d(coords):
    """Morton (Z-order) indices of integer voxel coordinates (..., 3) in
    [0, 1024) (port of ``morton3d`` of ``ssdnerf_tpu/ops/morton.py``):
    x's bits at positions 3k, y's at 3k + 1, z's at 3k + 2.  Returns
    (...,) int32."""
    c = coords.to(torch.int64)
    return (_expand_bits(c[..., 0]) | (_expand_bits(c[..., 1]) << 1)
            | (_expand_bits(c[..., 2]) << 2)).to(torch.int32)


def _compact_bits(v):
    """Inverse of :func:`_expand_bits`: every third bit of ``v`` (int64)
    gathered into the low 10."""
    v = v & 0x49249249
    v = (v | (v >> 2)) & 0xC30C30C3
    v = (v | (v >> 4)) & 0x0F00F00F
    v = (v | (v >> 8)) & 0xFF0000FF
    return (v | (v >> 16)) & 0x000003FF


def morton3d_invert(indices):
    """Inverse of :func:`morton3d`: (...,) Morton indices -> (..., 3)
    int32 voxel coordinates (x, y, z)."""
    i = indices.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([_compact_bits(i), _compact_bits(i >> 1),
                        _compact_bits(i >> 2)], dim=-1).to(torch.int32)


def morton_grid_indices(grid_size):
    """(H, H, H) int32 numpy array whose entry [x, y, z] is the Morton
    index of voxel (x, y, z): the permutation between the linear (x, y,
    z) layout and the reference's Morton layout."""
    r = torch.arange(grid_size)
    xyz = torch.stack(torch.meshgrid(r, r, r, indexing='ij'), dim=-1)
    return morton3d(xyz).numpy()
