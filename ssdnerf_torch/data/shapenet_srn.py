"""SRN-layout multi-view scene dataset (port of
``ssdnerf_tpu/data/shapenet_srn.py``): ``intrinsics.txt``, ``rgb/*.png``
and ``pose/*.txt`` a scene; poses normalised into the unit cube
(radius 0.5), conditioning / test view splits, a scene-list pickle cache,
precomputed codes (``code_dir``, ``code_only``) and ``test_pose_override``
cameras.  Returns numpy arrays, the same keys and values as the JAX
package's; PNGs are read by ``core.png`` (no cv2 or libpng needed).
"""
import os
import pickle
import random

import numpy as np

from ..core.png import read_pngs


def load_intrinsics(path):
    with open(path) as f:
        f_, cx, cy, _ = map(float, f.readline().split())
        f.readline()  # grid barycenter
        f.readline()  # scale
        height, width = map(int, f.readline().split())
    return f_, f_, cx, cy, height, width


def load_pose(path):
    return np.loadtxt(path, dtype=np.float32, delimiter=' ').reshape(4, 4)


class ShapeNetSRN:
    def __init__(self,
                 data_prefix,
                 code_dir=None,
                 code_only=False,
                 load_imgs=True,
                 specific_observation_idcs=None,
                 num_test_imgs=0,
                 random_test_imgs=False,
                 scene_id_as_name=False,
                 cache_path=None,
                 test_pose_override=None,
                 num_train_imgs=-1,
                 load_cond_data=True,
                 load_test_data=True,
                 max_num_scenes=-1,
                 radius=0.5,
                 test_mode=False,
                 step=1,
                 cache_decoded=False,
                 decode_threads=None,
                 **kwargs):
        self.data_prefix = data_prefix
        self.code_dir = code_dir
        self.code_only = code_only
        self.load_imgs = load_imgs
        self.specific_observation_idcs = specific_observation_idcs
        self.num_test_imgs = num_test_imgs
        self.random_test_imgs = random_test_imgs
        self.scene_id_as_name = scene_id_as_name
        self.cache_path = cache_path
        self.test_pose_override = test_pose_override
        self.num_train_imgs = num_train_imgs
        self.load_cond_data = load_cond_data
        self.load_test_data = load_test_data
        self.max_num_scenes = max_num_scenes
        self.step = step
        self.radius = np.full(3, radius, np.float32)
        self.center = np.zeros(3, np.float32)
        # decoded images kept as uint8 (cars_train: 2.4 GB), f32 per read
        self.cache_decoded = bool(cache_decoded)
        self._img_cache = {}
        self.decode_threads = int(decode_threads or
                                  min(16, os.cpu_count() or 1))

        self.load_scenes()

        if test_pose_override is not None:
            pose_dir = os.path.join(test_pose_override, 'pose')
            poses = [self._normalize_pose(load_pose(
                os.path.join(pose_dir, n)))
                for n in sorted(os.listdir(pose_dir))]
            self.test_poses = np.stack(poses)
            fx, fy, cx, cy, _, _ = load_intrinsics(
                os.path.join(test_pose_override, 'intrinsics.txt'))
            self.test_intrinsics = np.broadcast_to(
                np.array([fx, fy, cx, cy], np.float32),
                (len(poses), 4)).copy()
        else:
            self.test_poses = self.test_intrinsics = None

    def _normalize_pose(self, c2w):
        """Camera position into the unit cube."""
        out = c2w.copy()
        out[:3, 3] = (c2w[:3, 3] - self.center) / self.radius
        return out

    def load_scenes(self):
        if self.cache_path is not None and os.path.exists(self.cache_path):
            with open(self.cache_path, 'rb') as f:
                scenes = pickle.load(f)
        else:
            prefixes = self.data_prefix if isinstance(self.data_prefix, list) \
                else [self.data_prefix]
            scenes = []
            for prefix in prefixes:
                for name in os.listdir(prefix):
                    sample_dir = os.path.join(prefix, name)
                    if not os.path.isdir(sample_dir):
                        continue
                    intrinsics = load_intrinsics(
                        os.path.join(sample_dir, 'intrinsics.txt'))
                    image_dir = os.path.join(sample_dir, 'rgb')
                    image_names = sorted(os.listdir(image_dir))
                    image_paths = [os.path.join(image_dir, n)
                                   for n in image_names]
                    poses = [load_pose(os.path.join(
                        sample_dir, 'pose',
                        os.path.splitext(n)[0] + '.txt'))
                        for n in image_names]
                    scenes.append(dict(intrinsics=intrinsics,
                                       image_paths=image_paths, poses=poses))
            scenes = sorted(scenes,
                            key=lambda s: s['image_paths'][0].split('/')[-3])
            if self.cache_path is not None:
                os.makedirs(os.path.dirname(self.cache_path) or '.',
                            exist_ok=True)
                with open(self.cache_path, 'wb') as f:
                    pickle.dump(scenes, f)
        end = len(scenes)
        if self.max_num_scenes >= 0:
            end = min(end, self.max_num_scenes * self.step)
        self.scenes = scenes[:end:self.step]
        self.num_scenes = len(self.scenes)

    def scene_name(self, scene_id):
        if self.scene_id_as_name:
            return f'{scene_id:04d}'
        return self.scenes[scene_id]['image_paths'][0].split('/')[-3]

    def __len__(self):
        return self.num_scenes

    def _read_imgs(self, paths):
        """A scene's views as one (N, H, W, 3) f32 stack in [0, 1]."""
        if not self.cache_decoded:
            return read_pngs(paths, self.decode_threads).astype(
                np.float32) / 255.0
        missing = [p for p in paths if p not in self._img_cache]
        if missing:
            for p, img in zip(missing, read_pngs(missing,
                                                 self.decode_threads)):
                self._img_cache[p] = img
        return np.stack([self._img_cache[p] for p in paths]).astype(
            np.float32) / 255.0

    def __getitem__(self, scene_id):
        scene = self.scenes[scene_id]
        results = dict(scene_id=scene_id, scene_name=self.scene_name(scene_id))

        if not self.code_only:
            fx, fy, cx, cy, _, _ = scene['intrinsics']
            intr = np.array([fx, fy, cx, cy], np.float32)
            poses = scene['poses']
            image_paths = scene['image_paths']
            num_imgs = len(image_paths)

            def gather(img_ids):
                ps = [self._normalize_pose(np.asarray(poses[i], np.float32))
                      for i in img_ids]
                paths = [image_paths[i] for i in img_ids]
                out_imgs = self._read_imgs(paths) if self.load_imgs else None
                return (out_imgs, np.stack(ps),
                        np.broadcast_to(intr, (len(img_ids), 4)).copy(),
                        paths)

            if self.specific_observation_idcs is None:
                if self.num_train_imgs >= 0:
                    n_train = self.num_train_imgs
                else:
                    n_train = num_imgs - self.num_test_imgs
                if self.random_test_imgs:
                    cond_inds = random.sample(range(num_imgs), n_train)
                else:
                    cond_inds = np.round(np.linspace(
                        0, num_imgs - 1, n_train)).astype(np.int64).tolist()
            else:
                cond_inds = list(self.specific_observation_idcs)
            test_inds = [i for i in range(num_imgs) if i not in cond_inds]

            if self.load_cond_data and len(cond_inds) > 0:
                imgs, ps, it, paths = gather(cond_inds)
                results.update(cond_poses=ps, cond_intrinsics=it,
                               cond_img_paths=paths)
                if imgs is not None:
                    results['cond_imgs'] = imgs
            if self.load_test_data and len(test_inds) > 0:
                imgs, ps, it, paths = gather(test_inds)
                results.update(test_poses=ps, test_intrinsics=it,
                               test_img_paths=paths)
                if imgs is not None:
                    results['test_imgs'] = imgs

        code = self.load_code(scene_id)
        if code is not None:
            results['code'] = code

        if self.test_pose_override is not None:
            results['test_poses'] = self.test_poses
            results['test_intrinsics'] = self.test_intrinsics
        return results

    def load_code(self, scene_id):
        """The scene's cached state from ``code_dir`` (``<name>.npz``, else
        the reference's ``<name>.pth``), or None."""
        if self.code_dir is None:
            return None
        name = self.scene_name(scene_id)
        for ext in ('.npz', '.pth'):
            code_file = os.path.join(self.code_dir, name + ext)
            if os.path.exists(code_file):
                return _load_code_file(code_file)
        return None


def _load_code_file(path):
    """A cached scene state: .npz (this package's and the JAX package's) or
    .pth (the reference's)."""
    if path.endswith('.npz'):
        with np.load(path) as d:
            return {k: d[k] for k in d.files}
    import torch
    obj = torch.load(path, map_location='cpu', weights_only=False)
    out = dict(scene_name=obj.get('scene_name'))
    for k, v in obj.get('param', {}).items():
        out[k] = v.numpy() if hasattr(v, 'numpy') else v
    return out
