"""Convert scene-cache files between the reference's torch ``.pth`` format
({scene_name, param: {code_, density_grid, density_bitfield}, optimizer})
and this package's ``.npz`` format, in either direction (port of the JAX
package's ``tools/convert_cache.py``, which writes the same files):

    python -m ssdnerf_torch.tools.convert_cache <src_dir> <dst_dir>
        [--to npz|pth]

The reference stores density grids and bitfields in Morton (Z-order)
voxel order; this package uses linear (x, y, z) order.  The conversion
permutes both ways, the only place Morton order crosses the boundary.
"""
import argparse
import os

import numpy as np
import torch

from ..ops.morton import morton_grid_indices


def _perm(n_voxels):
    """The Morton index of each linear voxel of an H^3 grid."""
    H = round(n_voxels ** (1 / 3))
    if H ** 3 != n_voxels:
        raise ValueError(f'{n_voxels} voxels is not a cube')
    return morton_grid_indices(H).ravel()


def grid_morton_to_linear(grid):
    return grid[..., _perm(grid.shape[-1])]


def grid_linear_to_morton(grid):
    out = np.empty_like(grid)
    out[..., _perm(grid.shape[-1])] = grid
    return out


def _bits(bitfield):
    return np.unpackbits(bitfield, axis=-1, bitorder='little')


def _pack(bits):
    return np.packbits(bits, axis=-1, bitorder='little')


def bitfield_morton_to_linear(bf):
    return _pack(grid_morton_to_linear(_bits(bf)))


def bitfield_linear_to_morton(bf):
    return _pack(grid_linear_to_morton(_bits(bf)))


def pth_to_npz(src, dst):
    obj = torch.load(src, map_location='cpu', weights_only=False)
    param = obj['param']
    out = dict(scene_name=obj.get('scene_name', ''),
               scene_id=obj.get('scene_id', -1))
    code_key = 'code_' if 'code_' in param else 'code'
    out['code_'] = param[code_key].float().numpy()
    out['density_grid'] = grid_morton_to_linear(
        param['density_grid'].numpy())
    out['density_bitfield'] = bitfield_morton_to_linear(
        param['density_bitfield'].numpy())
    state = obj.get('optimizer', {}).get('state', {})
    if 0 in state:
        out['optimizer_m'] = state[0]['exp_avg'].float().numpy()
        out['optimizer_v'] = state[0]['exp_avg_sq'].float().numpy()
        step = state[0]['step']
        out['optimizer_step'] = np.int32(
            step.item() if hasattr(step, 'item') else step)
    np.savez(dst, **out)


def npz_to_pth(src, dst):
    with np.load(src) as d:
        param = dict(
            code_=torch.from_numpy(d['code_']),
            density_grid=torch.from_numpy(
                grid_linear_to_morton(d['density_grid'])),
            density_bitfield=torch.from_numpy(
                bitfield_linear_to_morton(d['density_bitfield'])))
        optimizer = {}
        if 'optimizer_m' in d:
            optimizer = dict(
                state={0: dict(
                    step=torch.tensor(float(d['optimizer_step'])),
                    exp_avg=torch.from_numpy(np.asarray(d['optimizer_m'],
                                                        np.float32)),
                    exp_avg_sq=torch.from_numpy(np.asarray(
                        d['optimizer_v'], np.float32)))},
                param_groups=[dict(params=[0])])
        name = str(d['scene_name']) if 'scene_name' in d else ''
    torch.save(dict(scene_name=name, param=param, optimizer=optimizer), dst)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('src_dir')
    parser.add_argument('dst_dir')
    parser.add_argument('--to', choices=['npz', 'pth'], default='npz')
    args = parser.parse_args(argv)
    os.makedirs(args.dst_dir, exist_ok=True)
    src_ext = '.pth' if args.to == 'npz' else '.npz'
    conv = pth_to_npz if args.to == 'npz' else npz_to_pth
    files = sorted(f for f in os.listdir(args.src_dir)
                   if f.endswith(src_ext))
    for f in files:
        name = os.path.splitext(f)[0]
        conv(os.path.join(args.src_dir, f),
             os.path.join(args.dst_dir, name + '.' + args.to))
    print(f'Converted {len(files)} files to {args.dst_dir}')


if __name__ == '__main__':
    main()
