"""ssdnerf_torch: the PyTorch / CUDA port of ssdnerf_tpu for NVIDIA Hopper.

Imports torch and never JAX.  Kernels are built from ``csrc/`` on first
use (see ``ops/kernels/_build.py``).
"""
from .apis.inference import init_model
from .config import Config
from .convert import load_jax_params
from .registry import build_model

__all__ = ['Config', 'build_model', 'init_model', 'load_jax_params']
