"""The seeded inputs of the cells, made on the device in a few large calls:
raw scene codes, posed views and their images.

Codes are smooth random fields (a 16 x 16 draw per channel, upsampled to
the plane's size), so that the decoder sees scenes with structure at the
planes' scale rather than white noise.  Images are smooth random colour
fields in [0, 1], made by the benchmark, not by the port's render: the
training loss only needs targets of the right shape and range."""
import math

import torch
import torch.nn.functional as F

SRN_INTRINSICS = (131.25, 131.25, 64.0, 64.0)   # SRN cars at 128 x 128
CHUNK = 256          # bank rows drawn by one call
CODE_GRID = 16       # side of a code channel's draw before upsampling


def smooth_codes(gen, num, code_size, scale, device):
    """(num, *code_size) f32 raw codes: ``scale`` times a 16 x 16 normal
    draw per channel, bilinearly upsampled to the planes' size."""
    lead, (h, w) = code_size[:-2], code_size[-2:]
    channels = math.prod(lead)
    z = torch.randn((num, channels, CODE_GRID, CODE_GRID), generator=gen,
                    device=device)
    up = F.interpolate(z, size=(h, w), mode='bilinear', align_corners=False)
    return (scale * up).reshape((num,) + tuple(code_size))


def bank_rows(ctx, rows, code_size, scale, device):
    """Raw codes of bank ``rows`` (a range or a list of row indices), each
    drawn with its chunk of ``CHUNK`` rows: a row's code depends only on
    the seed and the row."""
    rows = list(rows)
    out = torch.empty((len(rows),) + tuple(code_size), device=device)
    by_chunk = {}
    for i, r in enumerate(rows):
        by_chunk.setdefault(r // CHUNK, []).append((i, r))
    for c, members in by_chunk.items():
        gen = ctx.generator('bank', c, device=device)
        codes = smooth_codes(gen, CHUNK, code_size, scale, device)
        for i, r in members:
            out[i] = codes[r - c * CHUNK]
    return out


def look_at(eye, up=(0.0, 1.0, 0.0)):
    """OpenCV camera-to-world poses (..., 4, 4) (x right, y down, z
    forward) at ``eye`` (..., 3) looking at the origin."""
    fwd = -eye / eye.norm(dim=-1, keepdim=True)
    upv = torch.tensor(up, dtype=eye.dtype, device=eye.device).expand_as(fwd)
    right = torch.linalg.cross(fwd, upv)
    right = right / right.norm(dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    pose = torch.zeros(eye.shape[:-1] + (4, 4), dtype=eye.dtype,
                       device=eye.device)
    pose[..., :3, 0], pose[..., :3, 1], pose[..., :3, 2] = right, down, fwd
    pose[..., :3, 3] = eye
    pose[..., 3, 3] = 1.0
    return pose


def view_poses(gen, shape, radius, device):
    """Poses (*shape, 4, 4) on a sphere of ``radius``: azimuth uniform,
    elevation uniform in [0.05, 1.0] rad, looking at the origin."""
    u = torch.rand(tuple(shape) + (2,), generator=gen, device=device)
    az = 2 * math.pi * u[..., 0]
    el = 0.05 + 0.95 * u[..., 1]
    eye = radius * torch.stack([torch.cos(el) * torch.cos(az), -torch.sin(el),
                                torch.cos(el) * torch.sin(az)], dim=-1)
    return look_at(eye)


def smooth_images(gen, num, h, w, device):
    """(num, h, w, 3) f32 colour fields in (0, 1): an 8 x 8 normal draw
    per channel, upsampled, through a sigmoid."""
    z = torch.randn((num, 3, 8, 8), generator=gen, device=device)
    up = F.interpolate(z, size=(h, w), mode='bilinear', align_corners=False)
    return torch.sigmoid(2.0 * up).permute(0, 2, 3, 1).contiguous()
