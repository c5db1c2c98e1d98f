"""Analytic sphere scenes for the learning validators (the port's own copy
of ``look_at_pose``, ``render_sphere_scene`` and ``make_sphere_batch`` of
the repository's ``tests/synthetic.py``; numpy): view-consistent ground
truth images of Lambertian-like spheres on a white background, seen from
cameras on a ring."""
import numpy as np


def look_at_pose(cam_pos, target=(0., 0., 0.), up=(0., 1., 0.)):
    """OpenCV-style camera-to-world pose (x right, y down, z forward)."""
    cam_pos = np.asarray(cam_pos, np.float32)
    forward = np.asarray(target, np.float32) - cam_pos
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = right
    pose[:3, 1] = down
    pose[:3, 2] = forward
    pose[:3, 3] = cam_pos
    return pose



def render_sphere_scene(pose, fx, fy, cx, cy, h, w, center, radius, color,
                        bg=1.0, ss=1, color2=None, band_freq=14.0):
    """Analytic render of a Lambertian-ish sphere on a white background —
    view-consistent ground truth for 3D reconstruction tests.

    pose: (4, 4) c2w (x right, y down, z forward). Returns (h, w, 3).

    ss: supersampling factor.  The default hard silhouette caps the PSNR
    any volume renderer can reach (~2.5% boundary pixels with O(1) error
    bound novel-view PSNR to ~21 dB at 64^2 no matter how good the
    reconstruction); ss=4 renders at 4x and box-filters down, giving
    anti-aliased edges a NeRF's soft compositing can actually match.
    color2: if given, latitude bands (fixed world frequency band_freq,
    so one view pins the pattern) alternate color/color2 — the
    "higher-texture" scene family of ``validate_guided_recon``."""
    hs, ws = h * ss, w * ss
    ys, xs = np.mgrid[:hs, :ws]
    u = (xs + 0.5) / ss   # sub-pixel centers in original pixel coords
    v = (ys + 0.5) / ss
    dirs_cam = np.stack([(u - cx) / fx, (v - cy) / fy,
                         np.ones_like(u, np.float32)], -1)
    R, t = pose[:3, :3], pose[:3, 3]
    d = dirs_cam @ R.T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(t, d.shape)
    oc = o - np.asarray(center)
    b = (d * oc).sum(-1)
    c = (oc * oc).sum(-1) - radius ** 2
    disc = b * b - c
    hit = disc > 0
    t_hit = -b - np.sqrt(np.maximum(disc, 0))
    hit &= t_hit > 0
    p = o + t_hit[..., None] * d
    n = (p - np.asarray(center)) / radius
    # simple shading: color modulated by +y-ish light
    light = np.clip(0.6 + 0.4 * (n @ np.array([0.3, -0.8, 0.5])), 0, 1)
    img = np.full((hs, ws, 3), bg, np.float32)
    base = np.broadcast_to(np.asarray(color, np.float32), p.shape)
    if color2 is not None:
        bands = 0.5 + 0.5 * np.tanh(
            4.0 * np.sin(band_freq * (p[..., 1] - center[1])))
        base = base * bands[..., None] \
            + np.asarray(color2, np.float32) * (1 - bands[..., None])
    img[hit] = base[hit] * light[hit, None]
    if ss > 1:
        img = img.reshape(h, ss, w, ss, 3).mean(axis=(1, 3))
    return img


def make_sphere_batch(num_scenes=4, num_views=6, h=64, w=64, seed=0,
                      radius_cam=2.4, ss=1, texture=False):
    """View-consistent multi-sphere scenes + cameras on a ring.

    ss > 1 anti-aliases the ground truth (see render_sphere_scene);
    texture=True adds two-color latitude bands — one conditioning view
    pins the band phase and both colors, so single-view reconstruction
    of the far side is well-posed given a prior over this family."""
    rng = np.random.RandomState(seed)
    focal = 1.4 * w
    intr = np.array([focal, focal, w / 2, h / 2], np.float32)
    all_imgs, all_poses = [], []
    for s in range(num_scenes):
        center = rng.uniform(-0.15, 0.15, 3).astype(np.float32)
        radius = rng.uniform(0.35, 0.55)
        color = rng.uniform(0.2, 0.9, 3).astype(np.float32)
        color2 = rng.uniform(0.2, 0.9, 3).astype(np.float32) \
            if texture else None
        imgs, poses = [], []
        for v in range(num_views):
            ang = 2 * np.pi * v / num_views + 0.1 * s
            elev = 0.35 * np.sin(ang * 2 + s)
            pos = radius_cam * np.array([
                np.cos(ang) * np.cos(elev), np.sin(elev),
                np.sin(ang) * np.cos(elev)])
            pose = look_at_pose(pos)
            imgs.append(render_sphere_scene(
                pose, focal, focal, w / 2, h / 2, h, w, center, radius,
                color, ss=ss, color2=color2))
            poses.append(pose)
        all_imgs.append(np.stack(imgs))
        all_poses.append(np.stack(poses))
    return dict(
        scene_id=np.arange(num_scenes),
        scene_name=[f'{i:04d}' for i in range(num_scenes)],
        cond_imgs=np.stack(all_imgs).astype(np.float32),
        cond_poses=np.stack(all_poses).astype(np.float32),
        cond_intrinsics=np.broadcast_to(
            intr, (num_scenes, num_views, 4)).copy())
