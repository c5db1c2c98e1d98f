"""Tiny cells of the benchmark's real ones for CPU rehearsals: the same
configuration and traffic files, with the widths, grids, views and
sample counts cut so that a run takes seconds on the CPU."""
import copy
import types

import torch

from benchmark.harness import cells

MODEL = {
    'code_size': [3, 6, 16, 16], 'code_reshape': [18, 16, 16],
    'grid_size': 16, 'cache_size': 32,
    'diffusion.denoising.image_size': 16,
    'diffusion.denoising.base_channels': 32,
    'diffusion.denoising.channels_cfg': [1, 2],
    'diffusion.denoising.num_heads': 2,
    'diffusion.denoising.attention_res': [16, 8],
}
TRAIN_CFG = {'n_inverse_rays': 64, 'n_decoder_rays': 64}
TEST_CFG = {'num_timesteps': 3, 'density_step': 2}
TRAFFIC = {
    'train': {'scenes': 2, 'views': 2, 'size': 16, 'pool': 2, 'warmup': 1},
    'view': {'size': 24, 'warmup': 1, 'checked_frames': 3, 'path': 16,
             'density_sweeps': 2},
    'sample': {'scenes': 2, 'checked_batches': 1},
}


def _set(d, dotted, value):
    keys = dotted.split('.')
    for k in keys[:-1]:
        d = d[k]
    d[keys[-1]] = value


def tiny_cell(name):
    """Cell ``name`` with its configuration and traffic cut to tiny
    sizes."""
    cell = copy.deepcopy(cells.workload(name))
    spec = cell['config_spec']
    for k, v in MODEL.items():
        _set(spec['model'], k, v)
    spec['train_cfg'].update(TRAIN_CFG)
    spec['test_cfg'].update(TEST_CFG)
    cell['traffic'].update(TRAFFIC[cell['entry']])
    return cell


def args(seed=7, seconds=0.5, trace=0):
    return types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)


CPU = torch.device('cpu')
