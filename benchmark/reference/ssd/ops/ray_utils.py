"""Ray generation and ray-AABB utilities (torch port of
``ssdnerf_tpu/ops/ray_utils.py``)."""
import torch


def near_far_from_aabb(rays_o, rays_d, aabb, min_near=0.2):
    """Slab test of rays against an axis-aligned box.

    Args:
        rays_o, rays_d: (..., 3) ray origins / directions.
        aabb: (..., 6) [xmin, ymin, zmin, xmax, ymax, zmax], broadcast
            against the ray batch dims minus the last ray axis.
        min_near: minimum near distance.

    Returns:
        nears, fars: (...,); ``fars < nears`` marks a miss.
    """
    eps = 1e-15
    small = torch.where(rays_d < 0, torch.full_like(rays_d, -eps),
                        torch.full_like(rays_d, eps))
    inv_d = 1.0 / torch.where(rays_d.abs() < eps, small, rays_d)
    t0 = (aabb[..., :3] - rays_o) * inv_d
    t1 = (aabb[..., 3:] - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    nears = torch.clamp(tmin, min=min_near)
    fars = torch.where(tmax < nears, nears - 1.0, tmax)
    return nears, fars


def get_ray_directions(h, w, intrinsics):
    """Pixel-center camera-space directions: (*, 4) -> (*, h, w, 3)."""
    batch_shape = intrinsics.shape[:-1]
    dev, dt = intrinsics.device, intrinsics.dtype
    x = torch.linspace(0.5, w - 0.5, w, device=dev, dtype=dt)
    y = torch.linspace(0.5, h - 0.5, h, device=dev, dtype=dt)
    dir_x = (x - intrinsics[..., 2:3]) / intrinsics[..., 0:1]   # (*, w)
    dir_y = (y - intrinsics[..., 3:4]) / intrinsics[..., 1:2]   # (*, h)
    dir_x = dir_x[..., None, :].expand(batch_shape + (h, w))
    dir_y = dir_y[..., :, None].expand(batch_shape + (h, w))
    return torch.stack([dir_x, dir_y, torch.ones_like(dir_x)], dim=-1)


def get_rays(directions, c2w, norm=False):
    """Camera-space directions (*, h, w, 3) + c2w (*, 4, 4) -> world rays."""
    rot = c2w[..., None, None, :3, :3]
    rays_d = (rot * directions[..., None, :]).sum(-1)
    rays_o = c2w[..., None, None, :3, 3].expand(rays_d.shape)
    if norm:
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return rays_o, rays_d


def get_cam_rays(c2w, intrinsics, h, w):
    """World-space unit rays for a batch of cameras."""
    return get_rays(get_ray_directions(h, w, intrinsics), c2w, norm=True)

