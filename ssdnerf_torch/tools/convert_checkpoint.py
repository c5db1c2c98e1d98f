"""Convert a reference SSDNeRF torch checkpoint into a checkpoint of this
package (port of the JAX package's ``tools/convert_checkpoint.py``):

    python -m ssdnerf_torch.tools.convert_checkpoint <src.pth> <config>
        <out.ckpt> [--strict]

The reference checkpoints (mmcv: a dict whose 'state_dict' holds the
decoder / decoder_ema / diffusion / diffusion_ema tensors) map onto the
JAX package's parameter trees, which the port's modules load
(``convert.load_jax_params``):

- TriPlaneDecoder: ``decoder.base_net.0`` -> ``base_net/dense_0`` etc.
  (torch Linear weight (out, in) -> kernel (in, out));
- DenoisingUnetMod: the mmgen flat ``in_blocks`` / ``mid_blocks`` /
  ``out_blocks`` indices are enumerated by walking the same construction
  loops and matched to the named modules (in_conv / in_res_i /
  in_attn_i / down_l / mid_* / out_res_i / out_attn_i / up_l / out_norm
  / out_conv); the attention's qkv channels are permuted from mmgen's
  head-major split to (3, heads, head dim) per group.

The model of ``config`` is built with seeded weights (``init_model``), the
converted tensors replace each matching one, and the result is written
with ``core.checkpoint.save_checkpoint``, a checkpoint both packages read.
Best effort: unmatched source keys, missing targets and shape mismatches
are reported (a mismatched or missing tensor keeps its seeded value);
``--strict`` exits 1 on any of them before writing.
"""
import argparse
import sys

import numpy as np
import torch

from ..apis.inference import init_model
from ..config import Config
from ..convert import dump_params, load_jax_params, module_groups
from ..core.checkpoint import save_checkpoint


def _unet_block_map(cfg):
    """mmgen in / out block indices -> lists of (sub index, our module
    name, kind)."""
    channels_cfg = list(cfg.get('channels_cfg', [1, 2, 2, 4, 4]))
    rpd = cfg.get('resblocks_per_downsample', 2)
    image_size = cfg.get('image_size', 128)
    if isinstance(image_size, int):
        image_size = (image_size, image_size)
    attention_res = cfg.get('attention_res', [16, 8])
    attention_scale = [min(image_size) // int(r) for r in attention_res]

    in_map = {0: [('0', 'in_conv', 'conv')]}
    idx = 1
    scale = 1
    block_i = 0
    for level in range(len(channels_cfg)):
        for _ in range(rpd):
            entries = [('0', f'in_res_{block_i}', 'res')]
            if scale in attention_scale:
                entries.append(('1', f'in_attn_{block_i}', 'attn'))
            in_map[idx] = entries
            idx += 1
            block_i += 1
        if level != len(channels_cfg) - 1:
            in_map[idx] = [('0', f'down_{level}', 'down')]
            idx += 1
            scale *= 2

    out_map = {}
    block_i = 0
    idx = 0
    for level in range(len(channels_cfg)):
        for sub in range(rpd + 1):
            entries = [('0', f'out_res_{block_i}', 'res')]
            e = 1
            if scale in attention_scale:
                entries.append((str(e), f'out_attn_{block_i}', 'attn'))
                e += 1
            if level != len(channels_cfg) - 1 and sub == rpd:
                entries.append((str(e), f'up_{level}', 'up'))
                scale //= 2
            out_map[idx] = entries
            idx += 1
            block_i += 1
    return in_map, out_map


def _set(tree, path, value):
    d = tree
    for p in path[:-1]:
        d = d.setdefault(p, {})
    d[path[-1]] = value


def _conv_w(w):
    """torch conv (out, in, kh, kw) -> (kh, kw, in, out)."""
    return np.transpose(w, (2, 3, 1, 0))


def _conv1d_w(w):
    """torch conv1d (out, in, k) -> (k, in, out)."""
    return np.transpose(w, (2, 1, 0))


def _lin_w(w):
    return np.transpose(w, (1, 0))


def _map_resblock(src, prefix, out, our):
    base = ('params', our)
    _set(out, base + ('norm_1', 'scale'), src[prefix + 'conv_1.0.weight'])
    _set(out, base + ('norm_1', 'bias'), src[prefix + 'conv_1.0.bias'])
    _set(out, base + ('conv_1', 'kernel'),
         _conv_w(src[prefix + 'conv_1.2.weight']))
    _set(out, base + ('conv_1', 'bias'), src[prefix + 'conv_1.2.bias'])
    emb = prefix + 'norm_with_embedding.embedding_layer.1.'
    _set(out, base + ('embedding_dense', 'kernel'),
         _lin_w(src[emb + 'weight']))
    _set(out, base + ('embedding_dense', 'bias'), src[emb + 'bias'])
    _set(out, base + ('norm_2', 'scale'),
         src[prefix + 'norm_with_embedding.norm.weight'])
    _set(out, base + ('norm_2', 'bias'),
         src[prefix + 'norm_with_embedding.norm.bias'])
    # conv_2's index depends on dropout: Sequential(act, [dropout,] conv)
    c2 = prefix + 'conv_2.2.weight' if prefix + 'conv_2.2.weight' in src \
        else prefix + 'conv_2.1.weight'
    _set(out, base + ('conv_2', 'kernel'), _conv_w(src[c2]))
    _set(out, base + ('conv_2', 'bias'), src[c2[:-6] + 'bias'])
    if prefix + 'shortcut.weight' in src:
        _set(out, base + ('shortcut', 'kernel'),
             _conv_w(src[prefix + 'shortcut.weight']))
        _set(out, base + ('shortcut', 'bias'), src[prefix + 'shortcut.bias'])
    return [k for k in src if k.startswith(prefix)]


def _qkv_permute(w, groups, num_heads):
    """mmgen qkv channel layout -> ours.

    mmgen's attention reshape (``reshape(b, groups, -1, sp).transpose(1,
    2).reshape(b * num_heads, -1, groups * sp)`` then ``chunk(3)``) makes
    each group's output block head-major (heads, 3, hd); the port's
    SelfAttention reads (3, heads, hd).  Permute the out-channel axis.
    """
    out_ch = w.shape[0]
    hd = out_ch // groups // (3 * num_heads)
    w = w.reshape((groups, num_heads, 3, hd) + w.shape[1:])
    w = np.moveaxis(w, 2, 1)
    return w.reshape((out_ch,) + w.shape[4:])


def _map_attention(src, prefix, out, our, groups=1, num_heads=4):
    base = ('params', our)
    _set(out, base + ('norm', 'scale'), src[prefix + 'norm.weight'])
    _set(out, base + ('norm', 'bias'), src[prefix + 'norm.bias'])
    qkv_w = _qkv_permute(src[prefix + 'qkv.weight'], groups, num_heads)
    qkv_b = _qkv_permute(src[prefix + 'qkv.bias'], groups, num_heads)
    _set(out, base + ('qkv', 'kernel'), _conv1d_w(qkv_w))
    _set(out, base + ('qkv', 'bias'), qkv_b)
    _set(out, base + ('proj', 'kernel'),
         _conv1d_w(src[prefix + 'proj.weight']))
    _set(out, base + ('proj', 'bias'), src[prefix + 'proj.bias'])
    return [k for k in src if k.startswith(prefix)]


def convert_unet(src, unet_cfg):
    """``src``: numpy arrays keyed by mmgen module paths relative to the
    denoising module.  Returns (the UNet's tree ``{'params': ...}``, the
    source keys left unused)."""
    out = {}
    consumed = set()
    groups = unet_cfg.get('groups', 1)
    num_heads = unet_cfg.get('num_heads', 4)
    # mmgen TimeEmbedding.blocks = Seq(Linear, act, Linear)
    for j, i in ((0, 0), (1, 2)):
        _set(out, ('params', 'time_embedding', f'dense_{j}', 'kernel'),
             _lin_w(src[f'time_embedding.blocks.{i}.weight']))
        _set(out, ('params', 'time_embedding', f'dense_{j}', 'bias'),
             src[f'time_embedding.blocks.{i}.bias'])
    consumed.update(k for k in src if k.startswith('time_embedding.'))

    def map_blocks(kind_of, blocks):
        for idx, entries in kind_of.items():
            for sub, our, kind in entries:
                prefix = f'{blocks}.{idx}.{sub}.'
                if kind == 'conv':
                    _set(out, ('params', our, 'kernel'),
                         _conv_w(src[prefix[:-1] + '.weight']))
                    _set(out, ('params', our, 'bias'),
                         src[prefix[:-1] + '.bias'])
                    consumed.update([prefix + 'weight', prefix + 'bias'])
                elif kind == 'res':
                    consumed.update(_map_resblock(src, prefix, out, our))
                elif kind == 'attn':
                    consumed.update(_map_attention(src, prefix, out, our,
                                                   groups, num_heads))
                else:  # 'down' / 'up': one conv
                    conv = 'downsample' if kind == 'down' else 'conv'
                    _set(out, ('params', our, 'conv', 'kernel'),
                         _conv_w(src[prefix + conv + '.weight']))
                    _set(out, ('params', our, 'conv', 'bias'),
                         src[prefix + conv + '.bias'])
                    consumed.update(k for k in src if k.startswith(prefix))

    in_map, out_map = _unet_block_map(unet_cfg)
    map_blocks(in_map, 'in_blocks')
    consumed.update(_map_resblock(src, 'mid_blocks.0.', out, 'mid_res_0'))
    consumed.update(_map_attention(src, 'mid_blocks.1.', out, 'mid_attn',
                                   groups, num_heads))
    consumed.update(_map_resblock(src, 'mid_blocks.2.', out, 'mid_res_1'))
    map_blocks(out_map, 'out_blocks')
    # ConvModule order ('norm', 'act', 'conv') -> out_norm + out_conv
    for norm in ('out.gn', 'out.norm'):
        if norm + '.weight' in src:
            _set(out, ('params', 'out_norm', 'scale'), src[norm + '.weight'])
            _set(out, ('params', 'out_norm', 'bias'), src[norm + '.bias'])
            _set(out, ('params', 'out_conv', 'kernel'),
                 _conv_w(src['out.conv.weight']))
            _set(out, ('params', 'out_conv', 'bias'), src['out.conv.bias'])
            consumed.update(k for k in src if k.startswith('out.'))
            break
    return out, sorted(set(src) - consumed)


def convert_decoder(src):
    """``src`` keyed relative to the decoder module.  Returns (the
    decoder's tree, the source keys left unused)."""
    out = {}
    consumed = set()
    for net in ('base_net', 'density_net', 'color_net', 'dir_net'):
        j = 0
        # Sequential interleaves parameter-free activations
        for i in range(24):
            if f'{net}.{i}.weight' not in src:
                continue
            _set(out, ('params', net, f'dense_{j}', 'kernel'),
                 _lin_w(src[f'{net}.{i}.weight']))
            _set(out, ('params', net, f'dense_{j}', 'bias'),
                 src[f'{net}.{i}.bias'])
            consumed.update([f'{net}.{i}.weight', f'{net}.{i}.bias'])
            j += 1
    return out, sorted(set(src) - consumed)


def _flat(tree, prefix=()):
    """{path: array} of the leaves of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def merge(fresh, params):
    """``fresh`` (a module's dumped tree) with each leaf of ``params`` of
    the same path and shape put in its place; returns (tree, problems)."""
    flat_new = _flat(params)
    problems = []
    merged = {}
    for path, value in _flat(fresh).items():
        new = flat_new.get(path)
        if new is None:
            problems.append('missing ' + '/'.join(path))
        elif tuple(new.shape) != tuple(value.shape):
            problems.append(f'shape mismatch {"/".join(path)}: '
                            f'{tuple(new.shape)} vs {tuple(value.shape)}')
        else:
            value = new
        _set(merged, path, value)
    return merged, problems


def convert_state_dict(sd, model, unet_cfg):
    """Fill ``model``'s groups from a reference ``state_dict`` (numpy
    values); returns [(group, problems)], empty when every tensor
    matched."""
    problems = []
    targets = module_groups(model)
    for group in ('decoder', 'decoder_ema', 'diffusion', 'diffusion_ema'):
        sub = {k[len(group) + 1:]: v for k, v in sd.items()
               if k.startswith(group + '.')}
        if not sub or targets.get(group) is None:
            continue
        if group.startswith('decoder'):
            params, leftover = convert_decoder(sub)
        else:
            params, leftover = convert_unet(
                {k[len('denoising.'):]: v for k, v in sub.items()
                 if k.startswith('denoising.')}, unet_cfg)
        tree, issues = merge(dump_params(targets[group]), params)
        issues = [f'unused {k}' for k in leftover] + issues
        if issues:
            problems.append((group, issues))
        load_jax_params(model, {group: tree})
        print(f'{group}: converted {len(_flat(params))} tensors')
    return problems


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('src', help='reference .pth checkpoint')
    parser.add_argument('config', help='the matching config of this repo')
    parser.add_argument('out', help='output .ckpt path')
    parser.add_argument('--strict', action='store_true')
    args = parser.parse_args(argv)

    ckpt = torch.load(args.src, map_location='cpu', weights_only=False)
    sd = ckpt.get('state_dict', ckpt)
    sd = {k: v.numpy() if hasattr(v, 'numpy') else v for k, v in sd.items()}
    cfg = Config.fromfile(args.config)
    model = init_model(cfg, 'cpu')
    problems = convert_state_dict(sd, model,
                                  dict(cfg.model.diffusion.denoising))
    for group, issues in problems:
        print(f'[warn] {group}: {len(issues)} issues, e.g. {issues[:5]}')
    if problems and args.strict:
        sys.exit(1)
    save_checkpoint(args.out, model,
                    iteration=ckpt.get('meta', {}).get('iter', 0))
    print(f'Wrote {args.out}')


if __name__ == '__main__':
    main()
