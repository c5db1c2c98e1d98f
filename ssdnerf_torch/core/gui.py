"""Interactive viewer core (port of ``ssdnerf_tpu/core/gui.py``):
``OrbitCamera`` and ``SSDNeRFViewer``, which holds one scene (code, density
grid and bitfield) of a port model and generates, loads, saves, renders
and exports it with no UI toolkit, so it runs headless; the dearpygui
front end of ``ssdnerf_torch/demo/ssdnerf_gui.py`` drives it where
dearpygui and a display exist.

Every draw comes from a CPU ``torch.Generator`` and is moved to the
model's device, so a seed gives the same scene on the card and on the CPU.
It is not the JAX viewer's scene for that seed: JAX draws with
``PRNGKey(seed)``.
"""
import os

import numpy as np
import torch

from ..apis.inference import to_device
from ..data.shapenet_srn import _load_code_file, load_intrinsics, load_pose
from ..models.decoders.renderer import density_jitter, get_density
from .camera import surround_views
from .mesh import extract_geometry, save_stl

# sweeps of a scene's density rebuild in set_scene (the default of JAX's
# get_density, which the JAX viewer calls)
DENSITY_SWEEPS = 8


class OrbitCamera:
    def __init__(self, name, w, h, r=2.0, fovy=60.0, euler=(0, 0, 0)):
        self.name = name
        self.W = w
        self.H = h
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self.default_rot = self._euler_rot(euler)
        self.rot = self.default_rot.copy()
        self.up = np.array([0, 1, 0], np.float32)

    @staticmethod
    def _euler_rot(euler):
        rx, ry, rz = np.deg2rad(euler)

        def rot_x(a):
            return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                             [0, np.sin(a), np.cos(a)]], np.float32)

        def rot_y(a):
            return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                             [-np.sin(a), 0, np.cos(a)]], np.float32)

        def rot_z(a):
            return np.array([[np.cos(a), -np.sin(a), 0],
                             [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)

        return rot_z(rz) @ rot_y(ry) @ rot_x(rx)

    @property
    def pose(self):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = self.rot
        pose[:3, 3] = self.rot @ np.array([0, 0, -self.radius], np.float32) \
            + self.center
        return pose

    @property
    def intrinsics(self):
        focal = self.H / (2 * np.tan(np.deg2rad(self.fovy) / 2))
        return np.array([focal, focal, self.W / 2, self.H / 2], np.float32)

    def orbit(self, dx, dy, sensitivity=0.004):
        """Rotate about the camera's up and right axes."""
        right = self.rot[:, 0]
        rot_y = _axis_angle(self.up, -dx * sensitivity)
        rot_x = _axis_angle(right, -dy * sensitivity)
        self.rot = rot_y @ rot_x @ self.rot

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0, sensitivity=0.001):
        self.center += sensitivity * self.rot @ np.array(
            [dx, dy, dz], np.float32)


def _axis_angle(axis, angle):
    """Rotation by ``angle`` about ``axis`` (Rodrigues)."""
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]], np.float32)
    return np.eye(3, dtype=np.float32) + np.sin(angle) * K \
        + (1 - np.cos(angle)) * (K @ K)


class SSDNeRFViewer:
    """One active scene of ``model`` (a port ``DiffusionNeRF`` or
    ``MultiSceneNeRF``) on the model's device, rendered on demand with the
    EMA decoder.  The density rebuilds of :meth:`set_scene` draw from a
    generator seeded 0 (the JAX viewer's ``PRNGKey(0)``)."""

    def __init__(self, model, w=512, h=512, max_render_res=128,
                 cam_radius=2.0, cam_fovy=60.0):
        self.model = model
        self.device = next(model.parameters()).device
        self.cam = OrbitCamera('default', w, h, r=cam_radius, fovy=cam_fovy)
        self.max_render_res = max_render_res
        self.code = None
        self.density_grid = None
        self.density_bitfield = None
        self.generator = torch.Generator().manual_seed(0)

    def _tensor(self, value):
        return None if value is None else torch.as_tensor(
            value, device=self.device)

    # ---------------------------------------------------------------- #
    @torch.no_grad()
    def set_scene(self, code, density_grid=None, density_bitfield=None,
                  jitter=None):
        """Install a scene: ``code`` (*code_size) or (1, *code_size).
        Without a bitfield the density grid is rebuilt by
        ``DENSITY_SWEEPS`` sweeps of the EMA decoder, the jitter
        (sweeps, H^3, 3) drawn from the viewer's generator unless
        given."""
        code = self._tensor(code).float()
        if code.dim() == len(self.model.code_size):
            code = code[None]
        self.code = code
        if density_bitfield is None:
            if jitter is None:
                jitter = density_jitter(
                    self.model.grid_size, self.model.decoder.bound,
                    DENSITY_SWEEPS, self.generator, 'cpu')
            density_grid, density_bitfield = get_density(
                self.model.ema_decoder, code, self.model.grid_size,
                jitter.to(self.device),
                density_thresh=self.model.test_cfg.get('density_thresh',
                                                       0.01))
        self.density_grid = self._tensor(density_grid)
        self.density_bitfield = self._tensor(density_bitfield)

    @torch.no_grad()
    def load_scene_file(self, path):
        """Load a scene file: this package's or the JAX package's ``.npz``
        (``code``, or raw ``code_`` activated with the model's code
        activation state) or the reference's ``.pth``.  Its density grid
        and bitfield are used as stored (ROADMAP §3 item 22: a reference
        file's are in Morton order)."""
        blob = _load_code_file(path)
        code = blob.get('code')
        if code is None:
            code_ = torch.as_tensor(np.asarray(blob['code_'], np.float32),
                                    device=self.device)[None]
            code = self.model.code_activation(code_, self.model.code_act)[0]
        grid = blob.get('density_grid')
        bitfield = blob.get('density_bitfield')
        self.set_scene(code, None if grid is None else grid[None],
                       None if bitfield is None else bitfield[None])

    def save_scene_file(self, path):
        """``np.savez`` of the scene's code, density grid and bitfield,
        the JAX viewer's file."""
        np.savez(path, code=self.code[0].cpu().numpy(),
                 density_grid=self.density_grid[0].cpu().numpy(),
                 density_bitfield=self.density_bitfield[0].cpu().numpy())

    # ---------------------------------------------------------------- #
    def generate(self, seed=0, num_timesteps=None, draws=None):
        """Sample a new scene with the model's sampler and rebuild its
        density (``val_uncond``).  ``num_timesteps`` sets the sampler's
        steps in ``model.test_cfg``, which the sampler reads.  ``draws``
        (``DiffusionNeRF.val_draws``' dict for one scene: ``noise``,
        ``sample``, ``polish``, ``jitter``) replays every draw; else they
        come from ``torch.Generator().manual_seed(seed)``.  Returns the
        code (1, *code_size)."""
        if num_timesteps is not None:
            self.model.test_cfg['num_timesteps'] = num_timesteps
        if draws is None:
            draws = self.model.val_draws(
                1, generator=torch.Generator().manual_seed(seed))
        d = to_device(draws, self.device)
        self.code, self.density_grid, self.density_bitfield = \
            self.model.val_uncond(d['noise'], jitter=d['jitter'],
                                  draws=d['sample'], polish=d['polish'])
        return self.code

    def render_view(self, pose=None, intrinsics=None, h=None, w=None,
                    downscale=1):
        """One view (h, w, 3) f32 in [0, 1] from ``pose`` (default the
        camera's), at 1 / ``downscale`` of the size (the dynamic
        resolution while the user drags)."""
        if self.code is None:
            raise RuntimeError('no scene loaded')
        pose = self.cam.pose if pose is None else pose
        intrinsics = self.cam.intrinsics if intrinsics is None \
            else intrinsics
        h = (self.cam.H if h is None else h) // downscale
        w = (self.cam.W if w is None else w) // downscale
        intr = np.asarray(intrinsics, np.float32) / downscale
        image, _ = self.model.render(
            self.code, self.density_bitfield, h, w,
            torch.as_tensor(intr, device=self.device)[None, None],
            torch.as_tensor(np.asarray(pose, np.float32),
                            device=self.device)[None, None])
        return np.clip(image[0, 0].cpu().numpy(), 0, 1)

    def load_pose_file(self, path):
        """Point the camera along a saved pose: a 16-float SRN
        ``pose/*.txt`` or a (4, 4) ``.npy``, its position scaled by 2 into
        the unit scene as the dataset loader does."""
        if path.endswith('.npy'):
            pose = np.load(path).astype(np.float32).reshape(4, 4)
        else:
            pose = np.loadtxt(path, dtype=np.float32).reshape(4, 4)
        pose = pose.copy()
        pose[:3, 3] /= 0.5
        self.cam.rot = pose[:3, :3]
        self.cam.radius = float(np.linalg.norm(pose[:3, 3] - self.cam.center))
        return pose

    def load_camera_dir(self, path, camera_id=64):
        """Set the camera from an SRN-layout trajectory directory
        (``intrinsics.txt`` + ``pose/*.txt``): pose ``camera_id`` of the
        sorted listing (modulo its length), its position scaled into the
        unit scene, the field of view from the intrinsics."""
        pose_dir = os.path.join(path, 'pose')
        poses = sorted(os.listdir(pose_dir))
        pose = load_pose(os.path.join(
            pose_dir, poses[camera_id % len(poses)])).copy()
        pose[:3, 3] *= 2.0
        fx, fy, cx, cy, h, w = load_intrinsics(
            os.path.join(path, 'intrinsics.txt'))
        self.cam.rot = pose[:3, :3]
        self.cam.radius = float(np.linalg.norm(pose[:3, 3] - self.cam.center))
        self.cam.fovy = float(np.degrees(2 * np.arctan(0.5 * h / fy)))
        return pose

    def render_orbit_frames(self, num_frames=60, angle_amp=1.0):
        """The orbit's frames, uint8 (H, W, 3) each, ``render_view`` over
        ``surround_views`` of the camera's pose."""
        poses = surround_views(self.cam.pose, angle_amp=angle_amp,
                               num_frames=num_frames)
        return [(self.render_view(pose=p) * 255).astype(np.uint8)
                for p in poses]

    def render_orbit_video(self, path, num_frames=60, fps=20, angle_amp=1.0):
        """The orbit as a video file through imageio."""
        import imageio
        imageio.mimwrite(path, self.render_orbit_frames(num_frames,
                                                        angle_amp), fps=fps)
        return path

    def export_mesh(self, path, resolution=256, threshold=10.0):
        """Binary STL of the scene's density field by marching tetrahedra
        on a ``resolution``^3 grid (``core.mesh``)."""
        verts, tris = extract_geometry(self.model.ema_decoder, self.code[0],
                                       resolution=resolution,
                                       threshold=threshold)
        save_stl(path, verts, tris)
        return path
