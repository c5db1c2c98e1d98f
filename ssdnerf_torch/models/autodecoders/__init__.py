from .diffusion_nerf import DiffusionNeRF
from .multiscene import MultiSceneNeRF

__all__ = ['DiffusionNeRF', 'MultiSceneNeRF']
