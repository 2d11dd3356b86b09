"""Samplers and a prefetching loader (counterpart of
``hvrnet_tpu/data/loader.py``, mmdet's ``datasets/loader/``):

- ``GroupSampler`` / ``DistributedGroupSampler``: batches of images of one
  aspect group, shuffled by ``np.random.default_rng(seed)`` (each group,
  then the batches), padded to whole batches and, distributed, to whole
  ranks;
- ``DistributedSampler``: a rank's share of a test set, the dataset's own
  ``indices_list`` where it sets ``slices_set``, shuffled with
  ``shuffle`` by an explicit ``np.random.RandomState`` (the JAX sampler
  draws from numpy's global state);
- ``PrefetchLoader``: worker threads that call ``sample_fn`` on the
  indices and hand the items over in index order, at most
  ``LOOKAHEAD_PER_WORKER`` items per worker ahead of the consumer;
- ``build_dataloader``: the sampler a dataset needs and the loader.

Index orders are bit for bit the JAX package's.  The loader departs from
it three times, each with a test: an exception in a worker is raised in
the consumer at the item's turn (the JAX loader leaves the item missing
and its consumer waits for it forever), every pass starts its own workers
(a second pass of the JAX loader finds its stop flag set and waits
forever too), and the workers read a bounded number of items ahead (the
JAX workers read the whole list ahead, whatever the consumer takes).

Draws are reproducible only at one worker: with more, the items' calls
into the dataset's one generator (its retries, its pipeline's random
transforms) interleave as the threads are scheduled, as they do over the
JAX package's global state.  The index order holds at any count.
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Iterator

import numpy as np

LOOKAHEAD_PER_WORKER = 2     # items a worker may hold ahead of the consumer


class GroupSampler:
    def __init__(self, dataset, samples_per_gpu: int = 1, seed: int = 0):
        if not hasattr(dataset, "flag"):
            raise ValueError("GroupSampler needs a training dataset (one "
                             "with aspect-group flags)")
        self.dataset = dataset
        self.samples_per_gpu = samples_per_gpu
        self.flag = np.asarray(dataset.flag, np.int64)
        self.group_sizes = np.bincount(self.flag)
        self.num_samples = sum(
            int(np.ceil(size / samples_per_gpu)) * samples_per_gpu
            for size in self.group_sizes)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        indices = []
        for i, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            idx = np.where(self.flag == i)[0]
            self.rng.shuffle(idx)
            extra = int(np.ceil(size / self.samples_per_gpu)
                        ) * self.samples_per_gpu - len(idx)
            indices.append(np.concatenate([idx, idx[:extra]]))
        batches = np.concatenate(indices).reshape(-1, self.samples_per_gpu)
        self.rng.shuffle(batches)
        return iter(batches.reshape(-1).tolist())

    def __len__(self):
        return self.num_samples


class DistributedGroupSampler(GroupSampler):
    def __init__(self, dataset, samples_per_gpu: int = 1,
                 num_replicas: int = 1, rank: int = 0, seed: int = 0):
        super().__init__(dataset, samples_per_gpu, seed)
        self.num_replicas = num_replicas
        self.rank = rank
        self.num_samples = int(math.ceil(
            super().__len__() / num_replicas / samples_per_gpu)) \
            * samples_per_gpu
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        indices = list(super().__iter__())
        indices += indices[:self.total_size - len(indices)]
        offset = self.num_samples * self.rank
        return iter(indices[offset:offset + self.num_samples])

    def __len__(self):
        return self.num_samples


class DistributedSampler:
    def __init__(self, dataset, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = False, rng=None):
        self.dataset = dataset
        self.rank = rank
        if getattr(dataset, "slices_set", False):
            self.indices = list(dataset.indices_list[rank])
        else:
            n = len(dataset)
            per = int(math.ceil(n / num_replicas))
            self.indices = list(range(rank * per, min((rank + 1) * per, n)))
        if shuffle:
            if rng is None:
                raise ValueError("DistributedSampler(shuffle=True) needs "
                                 "rng, an np.random.RandomState")
            rng.shuffle(self.indices)

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


class _Failure:
    def __init__(self, error):
        self.error = error


class PrefetchLoader:
    """``sample_fn(idx)`` for each index of ``index_iter`` on
    ``num_workers`` threads, yielded in index order; a worker starts an
    item only within ``LOOKAHEAD_PER_WORKER * num_workers`` positions of
    the consumer's, so no more finished items than that wait."""

    def __init__(self, sample_fn, index_iter: Iterator[int],
                 num_workers: int = 2):
        self.sample_fn = sample_fn
        self.indices = list(index_iter)
        self.num_workers = max(1, num_workers)

    def __iter__(self):
        todo: "queue.Queue" = queue.Queue()
        for pos, idx in enumerate(self.indices):
            todo.put((pos, idx))
        results = {}
        ready = threading.Condition()
        stop = threading.Event()
        bound = LOOKAHEAD_PER_WORKER * self.num_workers
        next_pos = [0]                   # the consumer's position

        def worker():
            while not stop.is_set():
                try:
                    pos, idx = todo.get_nowait()
                except queue.Empty:
                    return
                with ready:
                    ready.wait_for(lambda: stop.is_set()
                                   or pos < next_pos[0] + bound)
                if stop.is_set():
                    return
                try:
                    out = self.sample_fn(idx)
                except BaseException as e:     # raised in the consumer
                    out = _Failure(e)
                with ready:
                    results[pos] = out
                    ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for pos in range(len(self.indices)):
                with ready:
                    ready.wait_for(lambda: pos in results)
                    out = results.pop(pos)
                    next_pos[0] = pos + 1
                    ready.notify_all()
                if isinstance(out, _Failure):
                    raise out.error
                yield out
        finally:
            with ready:
                stop.set()
                ready.notify_all()
            for t in threads:
                t.join()

    def __len__(self):
        return len(self.indices)


def dataset_is_test(dataset) -> bool:
    return bool(getattr(dataset, "test_mode", False))


def build_dataloader(dataset, imgs_per_gpu: int = 1, workers_per_gpu: int = 2,
                     num_replicas: int = 1, rank: int = 0,
                     shuffle: bool = True, seed: int = 0, **kwargs):
    """The loader of ``dataset``'s items: a test dataset in its rank's
    order (``DistributedSampler``), a training one by aspect groups of
    ``imgs_per_gpu`` (``GroupSampler``, or ``DistributedGroupSampler``
    over ``num_replicas``).  ``shuffle`` and ``kwargs`` are the config's,
    unused, as in the JAX package.  A training dataset's draws repeat
    from its seed only at ``workers_per_gpu=1`` (module docstring)."""
    if dataset_is_test(dataset):
        sampler = DistributedSampler(dataset, num_replicas, rank)
    elif num_replicas > 1:
        sampler = DistributedGroupSampler(dataset, imgs_per_gpu,
                                          num_replicas, rank, seed)
    else:
        sampler = GroupSampler(dataset, imgs_per_gpu, seed)
    return PrefetchLoader(lambda i: dataset[i], iter(sampler),
                          num_workers=workers_per_gpu)
