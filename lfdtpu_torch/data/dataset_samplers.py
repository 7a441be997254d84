# Dataset (index) samplers, a copy of `lfdtpu/data/dataset_samplers.py`
# (reference `lfd/data_pipeline/sampler/dataset_sampler.py`): the same
# `random.Random(seed)` draws in the same order, so a seed gives lfdtpu's
# index batches.
#
# Unlike the reference, every batch has EXACTLY batch_size indexes by default
# (the final short batch is padded by wrapping): the train step, its point
# grids and its padded GT keep one shape. `ragged_last=True` gives the
# reference's short final batch.

from __future__ import annotations

import math
import random

__all__ = [
    "BaseDatasetSampler",
    "RandomDatasetSampler",
    "COCORandomDatasetSampler",
    "RandomWithNegDatasetSampler",
    "ShardedDatasetSampler",
]


class BaseDatasetSampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def get_batch_size(self):
        raise NotImplementedError


class RandomDatasetSampler(BaseDatasetSampler):
    """Shuffle all indexes, yield sequential batches
    (`dataset_sampler.py:21-59`)."""

    def __init__(self, dataset, batch_size=1, shuffle=True, ignore_last=False,
                 ragged_last=False, seed=None):
        assert len(dataset) > 0
        self._indexes = dataset.get_indexes()
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._ignore_last = ignore_last
        self._ragged_last = ragged_last
        self._rng = random.Random(seed)
        assert batch_size <= len(self._indexes)
        n = len(self._indexes)
        if not ignore_last and n % batch_size != 0:
            self._loops = n // batch_size + 1
        else:
            self._loops = n // batch_size

    def __iter__(self):
        if self._shuffle:
            self._rng.shuffle(self._indexes)
        bs = self._batch_size
        for i in range(self._loops):
            batch = self._indexes[i * bs : (i + 1) * bs]
            if len(batch) < bs and not self._ragged_last:
                batch = batch + self._indexes[: bs - len(batch)]
            yield batch

    def __len__(self):
        return self._loops

    def get_batch_size(self):
        return self._batch_size


class COCORandomDatasetSampler(BaseDatasetSampler):
    """Aspect-ratio grouping (w/h < 1 vs rest), groups padded to a batch
    multiple by resampling (`dataset_sampler.py:62-113`)."""

    def __init__(self, dataset, batch_size=1, shuffle=True, seed=None):
        assert len(dataset) >= 1 and batch_size >= 1
        assert batch_size <= len(dataset)
        self._rng = random.Random(seed)
        self._group_indexes = {}
        for index in dataset.get_indexes():
            s = dataset[index]
            group_id = int(s["original_width"] / s["original_height"] < 1)
            self._group_indexes.setdefault(group_id, []).append(index)
        self._batch_size = batch_size
        self._shuffle = shuffle
        num_samples = 0
        for gid, idxs in self._group_indexes.items():
            pad = math.ceil(len(idxs) / batch_size) * batch_size - len(idxs)
            idxs = idxs + self._rng.sample(idxs, min(pad, len(idxs))) if pad else idxs
            while len(idxs) % batch_size:
                idxs.append(self._rng.choice(idxs))
            self._group_indexes[gid] = idxs
            num_samples += len(idxs)
        self._loop = num_samples // batch_size

    def __iter__(self):
        batches = []
        for idxs in self._group_indexes.values():
            if self._shuffle:
                self._rng.shuffle(idxs)
            for i in range(len(idxs) // self._batch_size):
                batches.append(idxs[i * self._batch_size : (i + 1) * self._batch_size])
        self._rng.shuffle(batches)
        yield from batches[: self._loop]

    def __len__(self):
        return self._loop

    def get_batch_size(self):
        return self._batch_size


class ShardedDatasetSampler(BaseDatasetSampler):
    """Per-process view of a global sampler for multi-process training.

    Every process constructs the SAME underlying sampler with the SAME seed
    and wraps it; process i then yields rows [i*per, (i+1)*per) of every
    global batch, so the processes' rows make up the batch one process
    would see. Pass the wrapped sampler to DataLoader (or call
    DataLoader.shard). process_index and process_count default to the
    torch.distributed process group's rank and size, and to (0, 1) without
    one (`lfdtpu/data/dataset_samplers.py:124-129`)."""

    def __init__(self, sampler, process_index=None, process_count=None):
        if process_index is None or process_count is None:
            import torch.distributed as dist

            grouped = dist.is_available() and dist.is_initialized()
            if process_index is None:
                process_index = dist.get_rank() if grouped else 0
            if process_count is None:
                process_count = dist.get_world_size() if grouped else 1
        global_bs = sampler.get_batch_size()
        assert global_bs % process_count == 0, (
            f"global batch {global_bs} not divisible by {process_count} hosts"
        )
        assert 0 <= process_index < process_count
        self._sampler = sampler
        self._index = process_index
        self._per = global_bs // process_count

    def __iter__(self):
        lo = self._index * self._per
        for batch in self._sampler:
            yield batch[lo : lo + self._per]

    def __len__(self):
        return len(self._sampler)

    def get_batch_size(self):
        return self._per


class RandomWithNegDatasetSampler(BaseDatasetSampler):
    """Pos/neg split; each batch carries int(batch_size*neg_ratio) negs
    sampled with replacement (`dataset_sampler.py:116-169`)."""

    def __init__(self, dataset, batch_size=1, neg_ratio=0.1, shuffle=True,
                 ignore_last=False, ragged_last=False, seed=None):
        assert len(dataset) > 0, "dataset is empty!"
        assert batch_size <= len(dataset)
        assert 0.0 <= neg_ratio <= 1.0
        self._rng = random.Random(seed)
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._ragged_last = ragged_last
        self._pos_indexes, self._neg_indexes = [], []
        for index in dataset.get_indexes():
            (self._pos_indexes if "bboxes" in dataset[index] else self._neg_indexes).append(index)
        if not self._neg_indexes:
            self._num_neg = 0
        else:
            self._num_neg = int(batch_size * neg_ratio)
        self._num_pos = batch_size - self._num_neg
        n_pos = len(self._pos_indexes)
        if not ignore_last and n_pos % self._num_pos != 0:
            self._loop = n_pos // self._num_pos + 1
        else:
            self._loop = n_pos // self._num_pos

    def __len__(self):
        return self._loop

    def get_batch_size(self):
        return self._batch_size

    def __iter__(self):
        if self._shuffle:
            self._rng.shuffle(self._pos_indexes)
        np_, k = self._num_pos, self._num_neg
        for i in range(self._loop):
            pos = self._pos_indexes[i * np_ : (i + 1) * np_]
            if len(pos) < np_ and not self._ragged_last:
                pos = pos + self._pos_indexes[: np_ - len(pos)]
            negs = [self._rng.choice(self._neg_indexes) for _ in range(k)] if k else []
            yield pos + negs
