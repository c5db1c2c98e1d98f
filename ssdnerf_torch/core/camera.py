"""Camera poses for the viewer and video export (numpy; the port's own copy
of ``ssdnerf_tpu/core/camera.py``): ``look_at`` and the ``surround_views``
orbit."""
import numpy as np


def _normalize(v, axis=-1):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), 1e-12)


def look_at(center, target, up):
    """Rotation matrices whose columns are [s, -u, f]: f the unit direction
    from ``center`` to ``target``, s = f x up, u = s x f."""
    f = _normalize(target - center)
    s = _normalize(np.cross(f, up))
    u = _normalize(np.cross(s, f))
    return np.stack([s, -u, f], axis=-1)


def surround_views(initial_pose, angle_amp=1.0, num_frames=60):
    """``num_frames`` camera-to-world poses (num_frames, 4, 4) f32 on an
    orbit about the z axis through the camera position of
    ``initial_pose``, at its distance from the origin, the elevation
    swinging by ``angle_amp`` about the initial one, each looking at the
    origin with z up."""
    initial_pose = np.asarray(initial_pose, np.float32)
    rad = np.linspace(0, 2 * np.pi, num=num_frames, endpoint=False,
                      dtype=np.float32)
    initial_pos = initial_pose[:3, -1]
    dist = np.linalg.norm(initial_pos)
    pos_norm = initial_pos / dist
    initial_angle = np.arcsin(pos_norm[-1])

    angles = initial_angle * (np.sin(rad) * angle_amp + 1)
    rot2d = np.stack([np.cos(rad), -np.sin(rad),
                      np.sin(rad), np.cos(rad)], axis=-1).reshape(-1, 2, 2)
    pos_xy = _normalize(pos_norm[:2], axis=0) @ rot2d  # (F, 2)
    pos = np.concatenate(
        [pos_xy * np.cos(angles)[:, None], np.sin(angles)[:, None]],
        axis=-1) * dist
    up = np.broadcast_to(np.array([0, 0, 1], np.float32), pos.shape)
    rot = look_at(pos, np.zeros_like(pos), up)
    poses = np.concatenate([rot, pos[..., None]], axis=-1)
    bottom = np.broadcast_to(np.array([0, 0, 0, 1], np.float32),
                             (num_frames, 1, 4))
    return np.concatenate([poses, bottom], axis=-2).astype(np.float32)
