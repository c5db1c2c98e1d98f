"""The model of a configuration on both sides, and the seeded weights the
benchmark gives both.

The weights follow ``chip_smoke.make_model``'s recipe, made on the device
in two flat draws instead of the JAX-style init leaf by leaf on the host:
every weight of two or more dimensions N(0, 1 / fan_in) plus N(0, 0.02^2),
every bias N(0, 0.02^2), every norm scale 1 + N(0, 0.02^2), and the
decoder's density bias lowered by 3, so that part of every density grid is
empty, as in a real scene.  The EMA modules start as copies of the live
ones and the scale-norm factor at 1."""
import torch
from torch import nn

CONFIG_KEYS = ('model', 'train_cfg', 'test_cfg')


def model_cfg(spec):
    return {k: spec[k] for k in CONFIG_KEYS}


def build_program(spec, device):
    """The port's model of configuration ``spec`` on ``device``, its
    parameters uninitialised (``install_weights`` fills them)."""
    from ssdnerf_torch.config import Config
    from ssdnerf_torch.registry import build_model
    cfg = Config._wrap(model_cfg(spec))
    with torch.device('meta'):
        model = build_model(cfg.model, train_cfg=cfg.get('train_cfg'),
                            test_cfg=cfg.get('test_cfg'))
    return model.to_empty(device=device)


def build_reference(spec, device):
    """The reference's model of ``spec`` on ``device``, uninitialised."""
    from benchmark.reference import ssd
    return ssd.build(model_cfg(spec), device)


def trained_leaves(model):
    """(name, parameter) of the live modules the weights cover, in
    ``named_parameters`` order."""
    return [(n, p) for n, p in model.named_parameters()
            if n.split('.')[0] in ('decoder', 'diffusion')]


def _norm_scales(model):
    names = set()
    for mname, m in model.named_modules():
        if isinstance(m, (nn.GroupNorm, nn.LayerNorm)) \
                and m.weight is not None:
            names.add(f'{mname}.weight')
    return names


@torch.no_grad()
def install_weights(model, seed, device):
    """Fill the live decoder's and diffusion's parameters from ``seed`` on
    ``device`` (module docstring), set the model's state as ``init_model``
    does, and copy the live modules into the EMA ones."""
    leaves = trained_leaves(model)
    total = sum(p.numel() for _, p in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((2, total), generator=gen, device=device)
    scales = _norm_scales(model)
    at = 0
    for name, p in leaves:
        n = p.numel()
        base, noise = (z[i, at:at + n].view(p.shape) for i in range(2))
        if p.dim() >= 2:
            value = base * (p[0].numel() ** -0.5) + 0.02 * noise
        elif name in scales:
            value = 1.0 + 0.02 * noise
        else:
            value = 0.02 * noise
        p.copy_(value)
        at += n
    model.decoder.density_net.dense_0.bias -= 3.0
    model.diffusion.norm_factor.fill_(1.0)
    model.code_act = model.code_activation.init_state(device)
    if model.init_code is not None:
        model.init_code = torch.zeros_like(model.init_code)
    model.reset_ema()
    return model


def apply_stage(model, spec, iteration):
    """The config changes ``ModelUpdaterHook`` has made by ``iteration``
    (those of its steps up to it, in order), set on ``model``: what the
    runner's hook does before a run resumed there."""
    for hook in spec.get('custom_hooks', []):
        if hook['type'] != 'ModelUpdaterHook':
            continue
        for step, cfg in sorted(zip(hook['step'], hook['cfgs']),
                                key=lambda sc: sc[0]):
            if 0 < step <= iteration:
                for key, value in cfg.items():
                    model.set_dotted(key, value)
