"""FID and KID (port of ``ssdnerf_tpu/core/evaluation/fid.py``): the
Frechet distance between Gaussian fits of Inception features (mmgen's
``_calc_fid``) and StyleGAN-ADA's polynomial-kernel KID (x1000), in numpy
and scipy on the host, as the JAX package computes them.  Real statistics
load from the ``{mean, cov, feats_np}`` pickle the reference writes.

Features come from the port's InceptionV3 on ``device``
(``feature_nets``; converted weights from ``inception_args.
inception_npz``, else seeded substitute weights, which tag the keys
``fid_substitute`` / ``kid_substitute``), or from the StyleGAN
TorchScript network at ``inception_args.inception_path`` when that file
exists.  KID's subsets are drawn from ``rng`` (a ``np.random.RandomState``,
seed 0 by default).
"""
import os
import pickle

import numpy as np
import scipy.linalg
import torch


class FID:
    name = 'FID'

    def __init__(self, num_images, inception_pkl=None, inception_args=None,
                 bgr2rgb=False, feature_extractor=None, device='cuda',
                 **kwargs):
        self.num_images = num_images
        self.inception_pkl = inception_pkl
        self.inception_args = dict(inception_args or {})
        self.bgr2rgb = bgr2rgb
        self.device = device
        self._extractor = feature_extractor
        self.real_mean = None
        self.real_cov = None
        self.real_feats = []
        self.fake_feats = []
        self.num_real_feeded = 0

    def prepare(self):
        if self.inception_pkl is not None and os.path.isfile(
                self.inception_pkl):
            with open(self.inception_pkl, 'rb') as f:
                ref = pickle.load(f)
            self.real_mean = ref['mean']
            self.real_cov = ref['cov']
            self.real_feats_np = ref.get('feats_np')
            self.num_real_feeded = self.num_images
        else:
            self.real_feats_np = None

    def _get_extractor(self):
        if self._extractor is None:
            from .feature_nets import make_inception_extractor
            path = self.inception_args.get('inception_path')
            npz = self.inception_args.get('inception_npz')
            if npz and os.path.isfile(npz):
                self._extractor = make_inception_extractor(
                    npz, device=self.device)
            elif path and os.path.isfile(path):
                self._extractor = _torchscript_inception(path, self.device)
            else:
                self._extractor = make_inception_extractor(
                    None, device=self.device)
        return self._extractor

    def feed(self, imgs, mode):
        """imgs: (N, H, W, 3) float in [0, 1] or uint8, numpy."""
        imgs = np.asarray(imgs)
        if imgs.dtype != np.uint8:
            imgs = np.clip(np.round(imgs * 255), 0, 255).astype(np.uint8)
        if self.bgr2rgb:
            imgs = imgs[..., ::-1]
        feats = np.asarray(self._get_extractor()(imgs))
        if mode == 'reals':
            self.real_feats.append(feats)
            self.num_real_feeded += len(feats)
        else:
            self.fake_feats.append(feats)

    @staticmethod
    def _calc_fid(fake_mean, fake_cov, real_mean, real_cov, eps=1e-6):
        """Frechet distance, its mean and covariance terms."""
        # (the JAX package passes disp=False, which newer scipy removed)
        cov_sqrt = scipy.linalg.sqrtm(fake_cov @ real_cov)
        if not np.isfinite(cov_sqrt).all():
            offset = np.eye(fake_cov.shape[0]) * eps
            cov_sqrt = scipy.linalg.sqrtm(
                (fake_cov + offset) @ (real_cov + offset))
        if np.iscomplexobj(cov_sqrt):
            cov_sqrt = cov_sqrt.real
        mean_diff = fake_mean - real_mean
        mean_norm = float(mean_diff @ mean_diff)
        trace = float(np.trace(fake_cov) + np.trace(real_cov)
                      - 2 * np.trace(cov_sqrt))
        return mean_norm + trace, mean_norm, trace

    @staticmethod
    def _calc_kid(real_feat, fake_feat, num_subsets, max_subset_size, rng):
        """StyleGAN-ADA KID over ``num_subsets`` subsets drawn from
        ``rng``."""
        n = real_feat.shape[1]
        m = min(min(real_feat.shape[0], fake_feat.shape[0]), max_subset_size)
        t = 0
        for _ in range(num_subsets):
            x = fake_feat[rng.choice(fake_feat.shape[0], m, replace=False)]
            y = real_feat[rng.choice(real_feat.shape[0], m, replace=False)]
            a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
            b = (x @ y.T / n + 1) ** 3
            t += (a.sum() - np.diag(a).sum()) / (m - 1) - b.sum() * 2 / m
        return float(t / num_subsets / m)

    def _fake_stats(self):
        fake = np.concatenate(self.fake_feats, axis=0)
        if fake.shape[0] < self.num_images:
            raise RuntimeError(f'got {fake.shape[0]} fake images, need '
                               f'{self.num_images}')
        fake = fake[:self.num_images]
        return fake, np.mean(fake, 0), np.cov(fake, rowvar=False)

    def _real_stats(self):
        if self.real_mean is None:
            feats = np.concatenate(self.real_feats, axis=0)[:self.num_images]
            self.real_feats_np = feats
            self.real_mean = np.mean(feats, 0)
            self.real_cov = np.cov(feats, rowvar=False)

    def _key(self, name):
        """``name``, tagged ``_substitute`` under substitute weights."""
        sub = getattr(self._extractor, 'substitute_weights', False)
        return f'{name}_substitute' if sub else name

    def summary(self):
        self._real_stats()
        _, fake_mean, fake_cov = self._fake_stats()
        fid, mean, cov = self._calc_fid(fake_mean, fake_cov, self.real_mean,
                                        self.real_cov)
        k = self._key('fid')
        self._result_str = f'{k} {fid:.4f} ({mean:.5f}/{cov:.5f})'
        self._result_dict = {k: fid, f'{k}_mean': mean, f'{k}_cov': cov}
        return fid, mean, cov

    def clear(self, clear_reals=False):
        self.fake_feats = []
        if clear_reals:
            self.real_feats = []
            self.num_real_feeded = 0

    @property
    def result_str(self):
        return getattr(self, '_result_str', '')

    @property
    def result_dict(self):
        return getattr(self, '_result_dict', {})


class FIDKID(FID):
    name = 'FIDKID'

    def __init__(self, num_images, num_subsets=100, max_subset_size=1000,
                 rng=None, **kwargs):
        super().__init__(num_images, **kwargs)
        self.num_subsets = num_subsets
        self.max_subset_size = max_subset_size
        self.rng = np.random.RandomState(0) if rng is None else rng

    def summary(self):
        self._real_stats()
        fake_np, fake_mean, fake_cov = self._fake_stats()
        fid, mean, cov = self._calc_fid(fake_mean, fake_cov, self.real_mean,
                                        self.real_cov)
        kid = self._calc_kid(self.real_feats_np, fake_np, self.num_subsets,
                             self.max_subset_size, self.rng) * 1000
        kf, kk = self._key('fid'), self._key('kid')
        self._result_str = (f'{kf} {fid:.4f} ({mean:.5f}/{cov:.5f}), '
                            f'{kk} {kid:.4f}')
        self._result_dict = {kf: fid, f'{kf}_mean': mean, f'{kf}_cov': cov,
                             kk: kid}
        return fid, mean, cov, kid


def _torchscript_inception(path, device='cuda'):
    """The StyleGAN TorchScript Inception at ``path`` as an extractor."""
    model = torch.jit.load(path, map_location=device).eval()

    def extract(imgs):
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(
                imgs.transpose(0, 3, 1, 2))).to(device)
            return np.concatenate([model(x[i:i + 32], return_features=True)
                                   .cpu().numpy()
                                   for i in range(0, len(x), 32)], 0)

    return extract


_METRICS = {'FID': FID, 'FIDKID': FIDKID}


def build_metric(cfg, feature_extractor=None, device='cuda'):
    cfg = dict(cfg)
    kind = cfg.pop('type')
    return _METRICS[kind](feature_extractor=feature_extractor, device=device,
                          **cfg)
