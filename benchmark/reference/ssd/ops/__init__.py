"""Ops layer of the reference (plain torch counterparts of the port's
``ops``)."""
from .activations import trunc_exp
from .compositing import composite_rays
from .marching import compact_samples, occupied_aabb, t_at_step
from .morton import packbits, unpackbits
from .packing import composite_packed, pack_groups
from .ray_utils import (get_cam_rays, get_ray_directions, get_rays,
                        near_far_from_aabb)
from .sh import sh_encode

__all__ = ['trunc_exp', 'composite_rays', 'compact_samples',
           'occupied_aabb', 't_at_step', 'packbits', 'unpackbits',
           'composite_packed', 'pack_groups', 'get_cam_rays',
           'get_ray_directions', 'get_rays', 'near_far_from_aabb',
           'sh_encode']
