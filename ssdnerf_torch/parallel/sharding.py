"""Data parallelism over processes, one a device (port of
``ssdnerf_tpu/parallel/sharding.py``).

The JAX package runs one program over a device mesh: the model and its
optimizer state replicated, the scene batch sharded along the scene axis,
XLA inserting the all-reduces.  The port runs one process a GPU, joined
by ``torch.distributed``; each name of the JAX module has its counterpart
here:

- ``make_mesh`` -> :func:`init_distributed`, which returns the run's
  :class:`Group` (the process group, this rank and its device);
- ``replicate`` -> :func:`replicate`, a broadcast of every parameter and
  buffer from rank 0;
- ``shard_scenes`` -> :func:`shard_scenes`, the rank's contiguous slice of
  a scene-leading batch (:func:`shard_train_draws` for a train step's
  draws, whose scene axis is not always the first);
- ``make_parallel_train_step`` / ``make_parallel_bank_step`` -> the models'
  own ``train_step`` with ``model.group`` set: every quantity the mesh
  reduces over the scene axis is reduced by :class:`Group` calls, one flat
  bucket a call (the gradients of each optimizer, the scale-norm and
  density statistics, the code activation's statistics, the mean code,
  the log vars), and all per-scene work stays local;
- ``sharded_volume_render`` -> :func:`sharded_volume_render`.

Every rank's batch holds the same number of scenes (the loader's batches
are full), so a mean over the global batch is the mean of the ranks'
means, and a rank's scenes carry ``1 / world_size`` of a batch-mean
loss's gradient (:attr:`Group.share`).
"""
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


class Group:
    """The processes of a data-parallel run (the default process group):
    ``rank`` of ``world_size``, and this rank's ``device``.  Its
    collectives move one flat bucket a call; the results are the same bits
    on every rank.  A deep copy of a model shares its group."""

    def __init__(self, rank, world_size, device):
        self.rank = rank
        self.world_size = world_size
        self.device = torch.device(device)

    def __deepcopy__(self, memo):
        return self

    @property
    def backend(self):
        return dist.get_backend()

    @property
    def share(self):
        """A rank's share of the global batch."""
        return 1.0 / self.world_size

    def _bucket(self, tensors, op, scale=None):
        """``tensors`` all-reduced with ``op``, one flat bucket of their
        dtype each (in their order); ``scale`` multiplies the sums."""
        tensors = [torch.as_tensor(t, device=self.device) for t in tensors]
        out = [None] * len(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].detach().reshape(-1).to(self.device)
                              for i in idx])
            dist.all_reduce(flat, op=op)
            if scale is not None:
                flat.mul_(scale)
            offset = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[offset:offset + n].view(tensors[i].shape)
                offset += n
        return out

    def mean(self, tensors):
        """The mean over the ranks of each tensor of ``tensors``."""
        return self._bucket(tensors, dist.ReduceOp.SUM, self.share)

    def sum(self, tensors):
        """The sum over the ranks of each tensor of ``tensors``."""
        return self._bucket(tensors, dist.ReduceOp.SUM)

    def broadcast_(self, tensors, src=0):
        """``tensors`` set in place to rank ``src``'s, one bucket a
        dtype."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1).to(self.device)
                              for t in ts])
            dist.broadcast(flat, src)
            offset = 0
            with torch.no_grad():
                for t in ts:
                    n = t.numel()
                    t.copy_(flat[offset:offset + n].view(t.shape))
                    offset += n

    def all_gather(self, tensor):
        """Every rank's ``tensor`` (of one shape on every rank), in rank
        order."""
        tensor = tensor.detach().contiguous().to(self.device)
        out = [torch.empty_like(tensor) for _ in range(self.world_size)]
        dist.all_gather(out, tensor)
        return out

    def all_gather_object(self, obj):
        """Every rank's picklable ``obj``, in rank order (through the
        rank's device under NCCL)."""
        out = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out


def default_backend(device):
    """NCCL for a CUDA device, gloo for the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def init_distributed(device, backend=None, rank=None, world_size=None,
                     init_method='env://', timeout=DEFAULT_TIMEOUT):
    """Join the run's processes (the counterpart of ``make_mesh``) and
    return its :class:`Group`.  ``rank`` / ``world_size`` default to the
    ``RANK`` / ``WORLD_SIZE`` environment (as ``torchrun`` sets them, with
    ``MASTER_ADDR`` / ``MASTER_PORT`` for ``env://``).  A CUDA ``device``
    becomes the process's current device before anything is allocated on
    it.  ``backend`` defaults to :func:`default_backend` of ``device``;
    gloo moves CUDA tensors too, and is what two ranks on one card need
    (NCCL refuses them).  A backend that fails to start raises: there is
    no fallback to another backend or to one process.  ``timeout`` bounds
    every collective."""
    device = torch.device(device)
    if device.type == 'cuda':
        if device.index is None:
            device = torch.device('cuda', int(os.environ.get('LOCAL_RANK',
                                                             0)))
        torch.cuda.set_device(device)
    if rank is None or world_size is None:
        if 'RANK' not in os.environ or 'WORLD_SIZE' not in os.environ:
            raise RuntimeError('joining from the environment needs RANK and '
                               'WORLD_SIZE (torchrun sets them)')
        rank = int(os.environ['RANK']) if rank is None else rank
        world_size = int(os.environ['WORLD_SIZE']) if world_size is None \
            else world_size
    backend = backend or default_backend(device)
    kwargs = dict(backend=backend, init_method=init_method, rank=rank,
                  world_size=world_size, timeout=timeout)
    if backend == 'nccl' and device.type == 'cuda':
        kwargs['device_id'] = device
    dist.init_process_group(**kwargs)
    return Group(rank, world_size, device)


def shutdown():
    """Leave the process group, when one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def replicate(module, group):
    """Every parameter and buffer of ``module`` set to rank 0's (the
    counterpart of ``replicate``): ranks seeded apart start from the same
    weights, so their EMA copies stay equal without a collective.
    Returns ``module``."""
    if group is not None:
        group.broadcast_([t for t in module.state_dict().values()
                          if torch.is_tensor(t)])
    return module


def shard_bounds(n, rank, world_size):
    """The rank's contiguous share ``[start, stop)`` of ``n`` items, the
    JAX package's ``np.round(np.linspace(0, n, world_size + 1))``
    split."""
    split = np.round(np.linspace(0, n, world_size + 1)).astype(int)
    return int(split[rank]), int(split[rank + 1])


def _slice(x, rank, world_size, axis):
    if not (torch.is_tensor(x) or isinstance(x, np.ndarray)) \
            or x.ndim <= axis:
        return x
    start, stop = shard_bounds(x.shape[axis], rank, world_size)
    index = (slice(None),) * axis + (slice(start, stop),)
    return x[index]


def shard_scenes(tree, rank, world_size, axis=0):
    """The rank's contiguous slice of every array leaf of ``tree`` along
    its scene axis ``axis`` (the counterpart of ``shard_scenes``; dicts,
    lists and tuples are walked, other leaves kept)."""
    if isinstance(tree, dict):
        return {k: shard_scenes(v, rank, world_size, axis)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_scenes(v, rank, world_size, axis)
                          for v in tree)
    return _slice(tree, rank, world_size, axis)


# The scene axis of each draw of ``train_draws`` (None: shared by the
# scenes); an inner loop's draws lead with the step.
_DRAW_AXES = dict(t=0, noise=0, ray_inds=0, perturb=0, cond_view=0,
                  jitter=None, dropout=0)
_INVERSE_AXES = dict(ray_inds=1, perturb=1, dropout=1, jitter=None)
_PARTIAL_AXES = dict(unif_idx=None, occ_u=0, jitter=0)


def shard_train_draws(draws, rank, world_size):
    """The rank's share of the draws of one global ``train_step``
    (``DiffusionNeRF.train_draws`` / ``MultiSceneNeRF.train_draws`` of
    the global batch): each scene's draws for the rank's scenes, the
    draws the scenes share (density jitters, the partial update's uniform
    voxels) whole.  The UNet's dropout masks are a dict of scene-leading
    masks."""
    def cut(value, axes, key):
        if value is None or axes[key] is None:
            return value
        return shard_scenes(value, rank, world_size, axes[key])

    out = {}
    for key, value in draws.items():
        if key == 'inverse' and value is not None:
            inner = {k: cut(v, _INVERSE_AXES, k) for k, v in value.items()
                     if k != 'partial'}
            if 'partial' in value:
                inner['partial'] = [{k: cut(v, _PARTIAL_AXES, k)
                                     for k, v in p.items()}
                                    for p in value['partial']]
            out[key] = inner
        else:
            out[key] = cut(value, _DRAW_AXES, key)
    return out


def sharded_volume_render(decoder, code, rays_o, rays_d, density_bitfield,
                          grid_size, group, **render_kwargs):
    """Render with the ray axis split over the ranks (the counterpart of
    ``sharded_volume_render``): each rank renders its contiguous slice of
    the N rays of every scene (N divisible by the world size) with
    ``volume_render``, and the outputs are all-gathered along axis 1 in
    one flat bucket.  Codes, bitfields and decoder weights are the same
    on every rank; a ``perturb`` (S, N) of ``render_kwargs`` is sliced
    with the rays.

    Args:
        rays_o, rays_d: (S, N, 3).
    Returns:
        ``volume_render``'s dict, every entry (S, N, ...) on every rank.
    """
    from ..models.decoders.renderer import volume_render
    S, N = rays_o.shape[:2]
    if N % group.world_size:
        raise ValueError(f'{N} rays do not split over {group.world_size} '
                         'ranks')
    n = N // group.world_size
    cut = slice(group.rank * n, (group.rank + 1) * n)
    kwargs = dict(render_kwargs)
    if kwargs.get('perturb') is not None:
        kwargs['perturb'] = kwargs['perturb'][:, cut]
    out = volume_render(decoder, code, rays_o[:, cut].contiguous(),
                        rays_d[:, cut].contiguous(), density_bitfield,
                        grid_size, **kwargs)
    keys = sorted(out)
    flat = torch.cat([out[k].float().reshape(-1) for k in keys])
    parts = [p.to(rays_o.device) for p in group.all_gather(flat)]
    result, offset = {}, 0
    for k in keys:
        local = out[k]
        size = local.numel()
        pieces = [p[offset:offset + size].view(local.shape).to(local.dtype)
                  for p in parts]
        result[k] = torch.cat(pieces, dim=1)
        offset += size
    return result
