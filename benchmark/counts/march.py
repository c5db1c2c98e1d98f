"""The march kernel's work: one occupancy lookup a march slot, reading the
slot's int32 voxel index and writing its bool, and the scene's bitfield
read once."""
from . import Work


def occupancy(slots, grid_size, scenes=1):
    return Work(flops=2 * slots,
                bytes=5 * slots + scenes * grid_size ** 3 // 8)
