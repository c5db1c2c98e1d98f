"""Ops layer of the port (torch counterparts of ``ssdnerf_tpu/ops``)."""
from .activations import trunc_exp
from .compositing import composite_rays
from .marching import (MarchResults, compact_samples, march_rays,
                       occupied_aabb, t_at_step, t_sequence)
from .morton import (morton3d, morton3d_invert, morton_grid_indices, packbits,
                     unpackbits)
from .packing import composite_packed, pack_groups
from .ray_utils import (get_cam_rays, get_ray_directions, get_rays,
                        near_far_from_aabb, sph_from_ray)
from .sh import sh_encode
from .triplane_sample import grid_sample_2d

__all__ = ['trunc_exp', 'composite_rays', 'compact_samples',
           'occupied_aabb', 't_at_step', 't_sequence', 'march_rays',
           'MarchResults', 'morton3d', 'morton3d_invert',
           'morton_grid_indices', 'packbits', 'unpackbits',
           'composite_packed', 'pack_groups', 'get_cam_rays',
           'get_ray_directions', 'get_rays', 'near_far_from_aabb',
           'sh_encode', 'sph_from_ray', 'grid_sample_2d']
