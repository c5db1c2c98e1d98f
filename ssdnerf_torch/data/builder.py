"""Dataset registry, batch collation and the training ``DataLoader`` (port
of ``ssdnerf_tpu/data/builder.py``): each process iterates only its
contiguous scene shard (``split_data``, so the rank's scene bank owns the
scenes it sees), shuffled per epoch, consecutive batches kept
scene-disjoint where possible, prefetched by a thread."""
import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .shapenet_srn import ShapeNetSRN

_DATASETS = {'ShapeNetSRN': ShapeNetSRN}


def register_dataset(name, cls):
    _DATASETS[name] = cls


def build_dataset(cfg):
    cfg = dict(cfg)
    kind = cfg.pop('type')
    return _DATASETS[kind](**cfg)


def collate(samples):
    """Stack per-scene dicts into batch arrays; string and path fields
    become lists, 'code' cache dicts a dict of stacked arrays."""
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        elif isinstance(vals[0], (int, np.integer)):
            batch[key] = np.asarray(vals)
        elif isinstance(vals[0], dict):
            batch[key] = {k: np.stack([v[k] for v in vals])
                          if isinstance(vals[0][k], np.ndarray) else
                          [v[k] for v in vals]
                          for k in vals[0]}
        else:
            batch[key] = vals
    return batch


class DataLoader:
    """Iterates full batches of the rank-local scene shard forever, in
    the order the JAX package's loader yields for the same arguments:
    each epoch is shuffled (``shuffle``) by ``np.random.RandomState(seed
    + rank)``, and an epoch whose first batch shares a scene with the
    previous batch is reshuffled, up to 20 times (``strict_disjoint``
    raises instead of going on).  ``check_batch_disjoint`` is accepted
    for the JAX loader's signature and, as there, ignored: the check is
    always made.  ``num_workers`` > 0 reads a batch's
    scenes on a thread pool (the config's ``workers_per_gpu``); a
    prefetch thread keeps ``prefetch`` batches ready, and an exception
    there is raised to the consumer."""

    def __init__(self, dataset, batch_size, rank=0, world_size=1,
                 split_data=True, shuffle=True, seed=0, prefetch=2,
                 check_batch_disjoint=True, strict_disjoint=False,
                 num_workers=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = int(num_workers)
        self._pool = None
        n = len(dataset)
        if split_data:
            split = np.round(np.linspace(0, n, world_size + 1)).astype(int)
            self.indices = np.arange(split[rank], split[rank + 1])
        else:
            self.indices = np.arange(rank, n, world_size)
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed + rank)
        self.strict_disjoint = strict_disjoint
        self._skip = 0
        self._queue = queue.Queue(maxsize=prefetch)
        self._thread = None
        self._stop = threading.Event()

    def skip_iters(self, n):
        """Fast-forward the batch order by ``n`` iterations without reading
        data, so that a resumed run sees the batches an uninterrupted one
        would.  Once iteration has started it warns and does nothing."""
        if self._thread is not None:
            warnings.warn('DataLoader already iterating; skip_iters ignored')
            return
        self._skip = int(n)

    def _epoch_order(self):
        order = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def _batches(self):
        bs = self.batch_size
        prev = set()
        while True:
            order = self._epoch_order()
            if len(order) <= bs:
                if self.strict_disjoint and prev:
                    raise RuntimeError(
                        'cannot keep consecutive batches scene-disjoint: '
                        f'shard of {len(order)} scenes <= batch size {bs}')
                prev = set()
            else:
                for _ in range(20):
                    if not (prev & set(order[:bs].tolist())):
                        break
                    self.rng.shuffle(order)
                else:
                    if self.strict_disjoint:
                        raise RuntimeError(
                            'failed to draw a scene-disjoint consecutive '
                            'batch after 20 reshuffles')
            for i in range(max(1, len(order) // bs)):
                batch_ids = order[i * bs:(i + 1) * bs]
                if len(batch_ids) < bs:
                    batch_ids = np.resize(batch_ids, bs)
                prev = set(batch_ids.tolist())
                yield batch_ids

    def _worker(self):
        try:
            for skipped, batch_ids in enumerate(self._batches()):
                if self._stop.is_set():
                    return
                if skipped < self._skip:
                    continue
                ids = [int(i) for i in batch_ids]
                if self.num_workers > 0:
                    if self._pool is None:
                        self._pool = ThreadPoolExecutor(
                            max_workers=self.num_workers)
                    samples = list(self._pool.map(self.dataset.__getitem__,
                                                  ids))
                else:
                    samples = [self.dataset[i] for i in ids]
                self._put(collate(samples))
        except Exception as exc:  # raised again in the consumer
            self._put(exc)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        if self._stop.is_set():
            raise RuntimeError('DataLoader closed')
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        while True:
            item = self._queue.get()
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        """Stop the prefetch thread and the thread pool."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
