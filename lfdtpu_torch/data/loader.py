# Host DataLoaders, a copy of `lfdtpu/data/loader.py` (reference
# `lfd/data_pipeline/data_loader/data_loader.py:11-165`).
#
# Same worker model: an index queue feeds N daemon workers; each worker
# decodes -> region-samples -> augments -> assembles a batch into a bounded
# queue, so host work overlaps the device steps. Batches are numpy, NHWC
# (float32, or uint8 when the normalize or the whole augmentation runs on the
# device), with the annotations both ragged per sample and padded to
# (B, Nmax) for the train step (gt_bboxes, gt_labels, gt_mask).
# parallel/prefetch.py puts them on the device.
#
# Order: every loader hands out its batches in the sampler's order, whatever
# order its workers finish them in. Each index batch is queued with its
# position k; workers return (k, batch), and the consumer yields batch k
# only after batches 0..k-1, keeping the ones that come early until their
# turn. A sharded loader (shard(): a rank of a data mesh loads only its rows
# of each global batch, data.ShardedDatasetSampler) thus gives its rows of
# global batch k at step k on every rank, and the ranks' rows make up one
# global batch (lfdtpu loads the global batch in one process; with several
# workers it hands out the batches in whatever order they finish, and the
# one-process order here is one of those). The consumer keeps at most
# `2 * num_workers` index batches queued ahead of it, so the early ones it
# holds stay bounded.
#
# A worker's error reaches the consumer, which raises it as soon as it
# arrives, whatever batch is due: a silently dead worker would starve the
# batch queue and hang the train loop.
#
# Process workers are forked from a parent that may hold a CUDA context and
# torch's thread pools: they run numpy only (no torch op, no CUDA).

from __future__ import annotations

import queue
import random
import threading

import numpy as np

from .dataset_samplers import ShardedDatasetSampler
from .device_aug import AUG_KEYS
from .jpeg import decode as jpeg_decode
from .sample import reserved_keys

__all__ = ["DataLoader", "ShmDataLoader", "pad_annotations"]

_NON_META_KEYS = set(reserved_keys) | set(AUG_KEYS)


def pad_annotations(annotation_batch, max_boxes):
    """Ragged [(bboxes (n,4), labels (n,)), ...] -> padded arrays.

    Returns (gt_bboxes (B, Nmax, 4) f32 xywh, gt_labels (B, Nmax) i32,
    gt_mask (B, Nmax) bool). Overflowing boxes are dropped (Nmax should be
    sized to the dataset's crop statistics)."""
    B = len(annotation_batch)
    gt = np.zeros((B, max_boxes, 4), np.float32)
    labels = np.zeros((B, max_boxes), np.int32)
    mask = np.zeros((B, max_boxes), bool)
    for i, (bboxes, lbls) in enumerate(annotation_batch):
        n = min(len(bboxes), max_boxes)
        if n:
            gt[i, :n] = bboxes[:n]
            labels[i, :n] = lbls[:n]
            mask[i, :n] = True
    return gt, labels, mask


class DataLoader:
    def __init__(
        self,
        dataset,
        dataset_sampler,
        region_sampler,
        augmentation_pipeline=None,
        num_workers=1,
        max_boxes_per_image=100,
        pad_divisor=None,
        image_dtype=np.float32,
        use_processes=False,
    ):
        # image_dtype=np.uint8 + a device preprocess in the executor ships
        # raw bytes (4x less host->device traffic than normalized f32).
        # use_processes forks worker PROCESSES instead of threads: sidesteps
        # the GIL and in-process contention with the host loop that drives
        # the device (the dataset is inherited copy-on-write via fork).
        self._dataset = dataset
        self._dataset_sampler = dataset_sampler
        self._loops = len(dataset_sampler)
        self._batch_size = dataset_sampler.get_batch_size()
        self._region_sampler = region_sampler
        self._augmentation_pipeline = augmentation_pipeline
        self._num_workers = num_workers
        self._max_boxes = max_boxes_per_image
        self._pad_divisor = pad_divisor
        self._image_dtype = image_dtype
        self._use_processes = use_processes

        if use_processes:
            import multiprocessing as mp

            ctx = mp.get_context("fork")
            self._index_queue = ctx.Queue()
            self._batch_queue = ctx.Queue(maxsize=max(num_workers, 1))
            self._ctx = ctx
        else:
            self._index_queue = queue.Queue()
            self._batch_queue = queue.Queue(maxsize=max(num_workers, 1))
        self._started = False
        self._processes = []
        self._epoch = 0  # tags the index batches of each iteration
        self._in_flight = 0  # index batches queued whose batch has not come back
        self._ahead = 2 * max(num_workers, 1)  # index batches queued ahead of the consumer

    def _start_workers(self):
        if self._use_processes:
            # CPython reseeds `random` in a forked child from the OS, so a
            # worker would ignore set_random_seed (lfdtpu's do, ROADMAP F11):
            # each worker seeds itself from a draw of the parent's stream
            for _ in range(self._num_workers):
                p = self._ctx.Process(target=self._seeded_worker,
                                      args=(random.getrandbits(64),), daemon=True)
                p.start()
                self._processes.append(p)
        else:
            for _ in range(self._num_workers):
                threading.Thread(target=self._worker_func, daemon=True).start()
        self._started = True

    @staticmethod
    def _decode_image(sample):
        """decode priority: in-memory array > bytes > path
        (`data_loader.py:48-65`)."""
        if "image" in sample:
            return sample["image"]
        if "image_bytes" in sample:
            return jpeg_decode(sample["image_bytes"])
        if "image_path" in sample:
            with open(sample["image_path"], "rb") as f:
                return jpeg_decode(f.read())
        raise ValueError('sample does not have "image", "image_bytes" or "image_path"!')

    def _assemble_images(self, image_batch):
        """Right/bottom zero-pad to batch max (H, W), NHWC
        (`data_loader.py:70-85`, which then went NCHW; the port's nets take
        NHWC)."""
        hmax = max(im.shape[0] for im in image_batch)
        wmax = max(im.shape[1] for im in image_batch)
        if self._pad_divisor:
            d = self._pad_divisor
            hmax = (hmax + d - 1) // d * d
            wmax = (wmax + d - 1) // d * d
        out = np.zeros((len(image_batch), hmax, wmax, 3), dtype=self._image_dtype)
        for i, im in enumerate(image_batch):
            out[i, : im.shape[0], : im.shape[1]] = im
        return out

    def _process_one(self, sample_index):
        sample = self._dataset[sample_index]
        sample_temp = {}
        if "bboxes" in sample:
            sample_temp["bboxes"] = sample["bboxes"]
            sample_temp["bbox_labels"] = sample["bbox_labels"]
        for meta_key in set(sample.keys()) - set(reserved_keys):
            sample_temp[meta_key] = sample[meta_key]

        image = self._decode_image(sample)
        assert image is not None
        sample_temp["image"] = image
        sample_temp = self._region_sampler(sample_temp)
        if sample_temp["image"].ndim == 2:  # gray -> 3 channels
            sample_temp["image"] = np.repeat(sample_temp["image"][..., None], 3, axis=-1)
        if self._augmentation_pipeline is not None:
            sample_temp = self._augmentation_pipeline(sample_temp)
        return sample_temp

    def _seeded_worker(self, seed):
        random.seed(seed)
        self._worker_func()

    def _worker_func(self):
        while True:
            epoch, k, index_batch, slot = self._index_queue.get()
            try:
                payload = self._produce_batch(index_batch, slot)
            except Exception as e:  # propagate: a silently-dead worker
                # would starve the batch queue and hang the train loop
                self._batch_queue.put(dict(worker_error=repr(e)))
                raise
            self._batch_queue.put((epoch, k, payload))

    def _produce_batch(self, index_batch, slot=None):
        images, annotations, metas = [], [], []
        aug = {k: [] for k in AUG_KEYS}
        for sample_index in index_batch:
            s = self._process_one(sample_index)
            images.append(s["image"])
            if "bboxes" in s:
                annotations.append(
                    (
                        np.asarray(s["bboxes"], np.float32).reshape(-1, 4),
                        np.asarray(s["bbox_labels"], np.int64),
                    )
                )
            else:
                annotations.append(
                    (np.empty((0, 4), np.float32), np.empty((0,), np.int64))
                )
            for k in AUG_KEYS:  # device-aug samplers attach these
                if k in s:
                    aug[k].append(s[k])
            meta_keys = set(s.keys()) - _NON_META_KEYS
            metas.append({k: s[k] for k in meta_keys} if meta_keys else None)

        image_batch = self._assemble_images(images)
        gt, labels, mask = pad_annotations(annotations, self._max_boxes)
        batch = dict(
            images=image_batch,
            annotations=annotations,
            gt_bboxes=gt,
            gt_labels=labels,
            gt_mask=mask,
            meta=metas,
        )
        for k, v in aug.items():
            if v:
                batch[k] = np.stack(v)
        return batch

    def _dispatch(self, epoch, k, sent, index_batches):
        """Queue index batches from number `sent` on while fewer than
        `_ahead` wait ahead of batch k. Returns how many are queued."""
        while sent < len(index_batches) and sent - k < self._ahead:
            self._queue(epoch, sent, index_batches[sent], None)
            sent += 1
        return sent

    def _queue(self, epoch, k, index_batch, slot):
        self._index_queue.put((epoch, k, index_batch, slot))
        self._in_flight += 1

    def _hand_out(self, payload):
        return payload

    def _discard(self, payload):
        """A batch of an iteration that was left before its end."""

    def __iter__(self):
        if not self._started:
            self._start_workers()
        self._epoch += 1
        epoch, index_batches = self._epoch, list(self._dataset_sampler)
        early, sent = {}, 0
        for k in range(len(index_batches)):
            sent = self._dispatch(epoch, k, sent, index_batches)
            while k not in early:
                item = self._batch_queue.get()
                if isinstance(item, dict):  # a worker's error, whatever batch is due
                    raise RuntimeError(f"data loader worker failed: {item['worker_error']}")
                got_epoch, j, payload = item
                self._in_flight -= 1
                if got_epoch == epoch:
                    early[j] = payload
                else:
                    self._discard(payload)
                sent = self._dispatch(epoch, k, sent, index_batches)
            yield self._hand_out(early.pop(k))

    def __len__(self):
        return self._loops

    @property
    def batch_size(self):
        return self._batch_size

    def shard(self, process_index=None, process_count=None):
        """Yield process_index's rows of every batch of process_count
        processes (ShardedDatasetSampler over the dataset sampler; the
        defaults come from the process group). Before the first iteration
        only. Returns self."""
        if self._started:
            raise RuntimeError("shard a DataLoader before its first iteration")
        self._dataset_sampler = ShardedDatasetSampler(self._dataset_sampler, process_index,
                                                      process_count)
        self._loops = len(self._dataset_sampler)
        self._batch_size = self._dataset_sampler.get_batch_size()
        return self

    def close(self):
        """Stop the worker processes (threads are daemons and stay)."""
        for p in self._processes:
            p.terminate()
            p.join(timeout=10)
        self._processes = []


class ShmDataLoader(DataLoader):
    """Process-worker loader with shared-memory batch transport.

    Purpose-built for TRAINING on fixed-size crops: python-thread loaders
    contend with the host loop that drives the device for the GIL, and
    mp.Queue would pickle every batch. Here workers are forked processes
    writing batches into preallocated shared-memory slots; the parent hands
    out zero-copy views, and a slot is recycled only when its consumer calls
    release_slot (parallel/prefetch.py does, once it has copied the batch's
    arrays out).

    Requires static crop_size (every reference training config has one) and
    emits the same batch dict as DataLoader minus per-sample 'annotations' /
    'meta' (not used by the train step).

    The consumer queues an index batch only together with a free slot, so
    the batch it waits for always has one: batches that come early hold
    theirs until their turn, and could otherwise take every slot from a
    worker still to fill the batch that is due. Idle workers hold no slot,
    so every slot is free again once an epoch's batches are released. A
    consumer that keeps every slot unreleased gets an error, not a hang.
    """

    def __init__(self, dataset, dataset_sampler, region_sampler,
                 augmentation_pipeline=None, num_workers=4,
                 max_boxes_per_image=100, crop_size=None,
                 image_dtype=np.uint8, num_slots=None):
        # a DeviceAugRegionSampler ships its fixed SOURCE buffer instead of
        # the crop — the slot image takes buffer_size and three small aux
        # arrays (scale/translation/flip) ride in the slot too
        self._aug = hasattr(region_sampler, "buffer_size")
        if self._aug:
            crop_size = region_sampler.buffer_size
        assert crop_size is not None, "ShmDataLoader needs the static crop_size"
        super().__init__(
            dataset, dataset_sampler, region_sampler,
            augmentation_pipeline=augmentation_pipeline,
            num_workers=num_workers, max_boxes_per_image=max_boxes_per_image,
            image_dtype=image_dtype, use_processes=True,
        )
        self._crop = int(crop_size)
        # one slot for each worker's batch in progress and two more: with a
        # late batch k, the workers go on to fill two batches beyond the N
        # in progress before they wait for k's turn, and a consumer that
        # keeps pace (prefetch_to_device releases each slot when it copies
        # the batch) frees one slot for each batch it takes
        self._num_slots = num_slots or (num_workers + 2)
        self._shm = None
        self._allocate_slots()
        # the consumer's own: it binds a slot to each index batch it queues,
        # and release_slot hands it back
        self._free_slots = queue.Queue()
        for i in range(self._num_slots):
            self._free_slots.put(i)

    def _allocate_slots(self):
        """The shared-memory slots for batches of the current batch size."""
        from multiprocessing import shared_memory

        if self._shm is not None:
            self._shm.close()
            self._shm.unlink()
        B, S, N = self._batch_size, self._crop, self._max_boxes
        itemsize = np.dtype(self._image_dtype).itemsize
        self._img_bytes = B * S * S * 3 * itemsize
        self._gt_bytes = B * N * 4 * 4
        self._lb_bytes = B * N * 4
        self._mk_bytes = B * N
        self._aug_bytes = B * 5 * 4 if self._aug else 0  # scale2+trans2+flip
        slot_bytes = (self._img_bytes + self._gt_bytes + self._lb_bytes
                      + self._mk_bytes + self._aug_bytes)
        self._shm = shared_memory.SharedMemory(create=True, size=slot_bytes * self._num_slots)
        self._slot_bytes = slot_bytes

    def shard(self, process_index=None, process_count=None):
        super().shard(process_index, process_count)
        self._allocate_slots()  # slots of the rank's batch
        return self

    def _slot_views(self, slot):
        B, S, N = self._batch_size, self._crop, self._max_boxes
        base = slot * self._slot_bytes
        buf = self._shm.buf
        o = base
        img = np.ndarray((B, S, S, 3), self._image_dtype, buf, o)
        o += self._img_bytes
        gt = np.ndarray((B, N, 4), np.float32, buf, o)
        o += self._gt_bytes
        lb = np.ndarray((B, N), np.int32, buf, o)
        o += self._lb_bytes
        mk = np.ndarray((B, N), bool, buf, o)
        if not self._aug:
            return img, gt, lb, mk
        o += self._mk_bytes
        aug = np.ndarray((B, 5), np.float32, buf, o)  # [sy,sx,ty,tx,flip]
        return img, gt, lb, mk, aug

    def _dispatch(self, epoch, k, sent, index_batches):
        """Queue index batches from number `sent` on, each with a free slot,
        while there is one. Returns how many are queued."""
        while sent < len(index_batches) and not self._free_slots.empty():
            self._queue(epoch, sent, index_batches[sent], self._free_slots.get())
            sent += 1
        if sent == k and not self._in_flight:  # no batch out there will free a slot
            raise RuntimeError(
                f"every one of the {self._num_slots} shared-memory slots holds a batch "
                "that was handed out and not released (release_slot)")
        return sent

    def _produce_batch(self, index_batch, slot=None):
        views = self._slot_views(slot)
        img, gt, lb, mk = views[:4]
        gt[:] = 0
        lb[:] = 0
        mk[:] = False
        for bi, sample_index in enumerate(index_batch):
            s = self._process_one(sample_index)
            im = s["image"]
            img[bi, : im.shape[0], : im.shape[1]] = im
            if im.shape[0] < img.shape[1]:
                img[bi, im.shape[0]:] = 0
            if im.shape[1] < img.shape[2]:
                img[bi, :, im.shape[1]:] = 0
            boxes = s.get("bboxes", [])
            n = min(len(boxes), self._max_boxes)
            if n:
                gt[bi, :n] = np.asarray(boxes[:n], np.float32)
                lb[bi, :n] = np.asarray(s["bbox_labels"][:n], np.int32)
                mk[bi, :n] = True
            if self._aug:
                aug = views[4]
                aug[bi, 0:2] = s["aug_scale"]
                aug[bi, 2:4] = s["aug_translation"]
                aug[bi, 4] = s["aug_flip"]
        return slot

    def _hand_out(self, slot):
        views = self._slot_views(slot)
        img, gt, lb, mk = views[:4]
        batch = dict(images=img, gt_bboxes=gt, gt_labels=lb, gt_mask=mk,
                     _slot=slot, _loader=self)
        if self._aug:
            aug = views[4]
            batch["aug_scale"] = aug[:, 0:2]
            batch["aug_translation"] = aug[:, 2:4]
            batch["aug_flip"] = aug[:, 4]
        return batch

    def _discard(self, slot):
        self._free_slots.put(slot)

    @property
    def num_slots(self):
        return self._num_slots

    def release_slot(self, batch):
        """Return a batch's slot once its arrays were copied out: the
        workers may overwrite it then."""
        self._free_slots.put(batch["_slot"])

    def close(self):
        super().close()
        self._shm.close()
        self._shm.unlink()
