"""Single-stage diffusion NeRF, unconditional generation (port of
``DiffusionNeRF.val_uncond`` of
``ssdnerf_tpu/models/autodecoders/diffusion_nerf.py``)."""
import torch

from ..decoders.renderer import density_jitter, get_density
from ..diffusions.gaussian_diffusion import GaussianDiffusion
from .multiscene import MultiSceneNeRF


class DiffusionNeRF(MultiSceneNeRF):

    def __init__(self, cfg, train_cfg=None, test_cfg=None):
        super().__init__(cfg, train_cfg, test_cfg)
        cfg = dict(cfg)
        self.diffusion = GaussianDiffusion.from_cfg(cfg['diffusion'])
        if cfg.get('code_permute') is not None:
            raise NotImplementedError('code_permute is not ported')
        self.code_reshape = tuple(cfg['code_reshape']) \
            if cfg.get('code_reshape') else None

    # code <-> diffusion layout
    def code_diff_pr(self, code):
        if self.code_reshape is None:
            return code
        return code.reshape((code.shape[0],) + self.code_reshape)

    def code_diff_pr_inv(self, code_diff):
        if self.code_reshape is None:
            return code_diff
        return code_diff.reshape((code_diff.shape[0],) + self.code_size)

    @torch.no_grad()
    def sample_codes(self, noise):
        """DDIM chain from noise (S, *code_size) -> codes (S, *code_size)."""
        code_diff = self.diffusion.sample_from_noise(
            self.code_diff_pr(noise), cfg=self.test_cfg)
        return self.code_diff_pr_inv(code_diff.float())

    @torch.no_grad()
    def rebuild_density(self, code, generator=None, jitter=None):
        """Density grid (S, H^3) f16 and bitfield (S, H^3 // 8) from
        ``density_step`` sweeps; the intra-voxel jitter is drawn from
        ``generator`` unless given as (density_step, H^3, 3)."""
        tcfg = self.test_cfg
        if jitter is None:
            jitter = density_jitter(self.grid_size, self.decoder.bound,
                                    tcfg.get('density_step', 8), generator,
                                    code.device)
        return get_density(self.decoder, code, self.grid_size, jitter,
                           density_thresh=tcfg.get('density_thresh', 0.01))

    def val_uncond(self, noise, generator=None, jitter=None):
        """Unconditional generation: DDIM sampling then the density
        rebuild.  Returns (code, density_grid, density_bitfield)."""
        if self.test_cfg.get('n_inverse_steps', 0) > 0:
            raise NotImplementedError('diffusion-prior code polish '
                                      '(n_inverse_steps > 0) is not ported')
        code = self.sample_codes(noise)
        grid, bitfield = self.rebuild_density(code, generator, jitter)
        return code, grid, bitfield
