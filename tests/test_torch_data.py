# The port's host data pipeline (lfdtpu_torch/data) against lfdtpu's on the
# same seeded inputs:
#   - packs cross over both ways (the [meta_info, {index: Sample}] schema);
#   - dataset samplers: the same index batches for the same seed (exact);
#   - region samplers: the same boxes (exact) and images within 1 uint8
#     step of lfdtpu's cv2 path (the port resizes with data/resize.py);
#   - augmentation and pad_annotations: exact;
#   - DataLoader with one worker after set_random_seed: lfdtpu's batches
#     (boxes exact, images within 1 uint8 step);
#   - ShmDataLoader through parallel.prefetch_to_device: every batch
#     intact, each slot released only after its batch was copied out.
import random

import numpy as np
import pytest
import torch

import lfdtpu.data as jdata
import lfdtpu_torch.data as tdata
from lfdtpu.execution.utils import set_random_seed as jax_set_random_seed
from lfdtpu_torch.execution.utils import set_random_seed
from lfdtpu_torch.parallel import prefetch_to_device

torch.set_num_threads(1)

LSB = 1  # uint8 steps: OpenCV's fixed-point resize against the port's


def _samples(pkg, n=12, seed=0, gray_every=5, neg_every=4):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        s = pkg.Sample()
        h, w = 60 + 7 * i, 80 + 5 * i
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        s["image"] = img[..., 0].copy() if i % gray_every == gray_every - 1 else img
        s["original_height"], s["original_width"] = h, w if i % 2 else h // 2
        if i % neg_every != neg_every - 1:
            k = 1 + i % 3
            s["bboxes"] = [[int(rng.randint(0, w - 20)), int(rng.randint(0, h - 20)),
                            int(rng.randint(4, 20)), int(rng.randint(4, 20))]
                           for _ in range(k)]
            s["bbox_labels"] = [int(rng.randint(2)) for _ in range(k)]
        out.append(s)
    return out


class _ListParser:
    def __init__(self, samples):
        self._samples = samples

    def get_meta_info(self):
        return {"classes": 2}

    def generate_sample(self):
        yield from self._samples


class _MemDataset:
    def __init__(self, samples):
        self._s = dict(enumerate(samples))

    def __getitem__(self, i):
        return self._s[i]

    def __len__(self):
        return len(self._s)

    def get_indexes(self):
        return list(self._s)


def _same_samples(a, b):
    assert set(a.keys()) == set(b.keys())
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_packs_cross_over_both_ways(tmp_path):
    jpath, tpath = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
    jds = jdata.Dataset(parser=_ListParser(_samples(jdata)), save_path=jpath, verbose=False)
    tds = tdata.Dataset(parser=_ListParser(_samples(tdata)), save_path=tpath, verbose=False)
    from_j = tdata.Dataset(load_path=jpath)
    from_t = jdata.Dataset(load_path=tpath)
    assert type(from_j[0]) is tdata.Sample  # lfdtpu's Sample maps onto the port's
    for a, b in ((jds, from_j), (tds, from_t), (jds, tds)):
        assert len(a) == len(b) and a.meta_info == b.meta_info
        for i in a.get_indexes():
            _same_samples(a[i], b[i])
    assert from_j.get_dataset_statistics() == jds.get_dataset_statistics()


def _sampler_pairs(ds_j, ds_t):
    yield (jdata.RandomDatasetSampler(ds_j, batch_size=5, seed=3),
           tdata.RandomDatasetSampler(ds_t, batch_size=5, seed=3))
    yield (jdata.RandomDatasetSampler(ds_j, batch_size=5, shuffle=False, ignore_last=True),
           tdata.RandomDatasetSampler(ds_t, batch_size=5, shuffle=False, ignore_last=True))
    yield (jdata.RandomWithNegDatasetSampler(ds_j, batch_size=4, neg_ratio=0.5, seed=4),
           tdata.RandomWithNegDatasetSampler(ds_t, batch_size=4, neg_ratio=0.5, seed=4))
    yield (jdata.COCORandomDatasetSampler(ds_j, batch_size=3, seed=5),
           tdata.COCORandomDatasetSampler(ds_t, batch_size=3, seed=5))
    yield (jdata.ShardedDatasetSampler(jdata.RandomDatasetSampler(ds_j, 6, seed=6), 1, 3),
           tdata.ShardedDatasetSampler(tdata.RandomDatasetSampler(ds_t, 6, seed=6), 1, 3))


def test_dataset_samplers_give_lfdtpus_batches():
    ds_j, ds_t = _MemDataset(_samples(jdata)), _MemDataset(_samples(tdata))
    for js, ts in _sampler_pairs(ds_j, ds_t):
        assert len(js) == len(ts) and js.get_batch_size() == ts.get_batch_size()
        for _ in range(3):  # epochs: the shuffles continue one stream
            assert list(js) == list(ts), type(ts).__name__


def _region_pairs():
    yield (lambda m: m.RandomBBoxCropRegionSampler(crop_size=48, resize_range=(0.5, 1.5),
                                                   resize_prob=0.5))
    yield (lambda m: m.RandomBBoxCropWithRangeSelectionRegionSampler(
        crop_size=48, detection_ranges=((4, 12), (12, 24), (24, 48)), range_mode="longer",
        lock_threshold=8))
    yield (lambda m: m.TypicalCOCOTrainingRegionSampler(
        resize_shorter_range=(40, 90), resize_longer_limit=120, pad_divisor=16))
    yield (lambda m: m.IdleRegionSampler())


@pytest.mark.parametrize("make", list(_region_pairs()), ids=["bbox", "range", "coco", "idle"])
def test_region_samplers_match_lfdtpu(make):
    js, ts = make(jdata), make(tdata)
    worst = 0
    for seed, (sj, st) in enumerate(zip(_samples(jdata, seed=1), _samples(tdata, seed=1))):
        for draw in range(3):
            random.seed(100 * seed + draw)
            a = js(dict(sj))
            after_j = random.random()
            random.seed(100 * seed + draw)
            b = ts(dict(st))
            assert random.random() == after_j  # the same number of draws
            assert a.get("bboxes") == b.get("bboxes") and a.get("bbox_labels") == b.get(
                "bbox_labels")
            for k in ("resize_scale", "resized_height", "resized_width"):
                assert a.get(k) == b.get(k)
            assert a["image"].shape == b["image"].shape and a["image"].dtype == b["image"].dtype
            worst = max(worst, int(np.abs(a["image"].astype(int) - b["image"].astype(int)).max()))
    assert worst <= LSB


def test_augmentation_and_pad_annotations_are_exact():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    boxes = [[3, 4, 10, 12], [20, 5, 8, 8]]
    for name in ("simple_widerface_train_pipeline", "simple_widerface_val_pipeline",
                 "typical_coco_train_pipeline", "typical_coco_val_pipeline"):
        for seed in range(4):
            random.seed(seed)
            a = getattr(jdata, name)(dict(image=img.copy(), bboxes=[list(b) for b in boxes]))
            random.seed(seed)
            b = getattr(tdata, name)(dict(image=img.copy(), bboxes=[list(b) for b in boxes]))
            assert np.array_equal(a["image"], b["image"]) and a["bboxes"] == b["bboxes"]
    a = jdata.Compose([jdata.HorizontalFlip(1.0), jdata.BGR2RGB()])(dict(image=img.copy()))
    b = tdata.Compose([tdata.HorizontalFlip(1.0), tdata.BGR2RGB()])(dict(image=img.copy()))
    assert np.array_equal(a["image"], b["image"])
    ann = [(rng.rand(n, 4).astype(np.float32) * 50, rng.randint(0, 3, n)) for n in (0, 3, 9)]
    for got, ref in zip(tdata.pad_annotations(ann, 5), jdata.pad_annotations(ann, 5)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def _loader(pkg, samples, device_aug, seed_fn):
    ds = _MemDataset(samples)
    # scales >= 0.6 keep the device-aug window inside its buffer: lfdtpu's
    # pre-shrink can raise below (ROADMAP F10, test_torch_device_aug.py)
    region = pkg.RandomBBoxCropRegionSampler(crop_size=48, resize_range=(0.6, 1.5),
                                             resize_prob=0.7)
    if device_aug:
        region = pkg.DeviceAugRegionSampler(region, flip_p=0.5)
    loader = pkg.DataLoader(
        ds, pkg.RandomWithNegDatasetSampler(ds, batch_size=4, neg_ratio=0.25, seed=7),
        region, augmentation_pipeline=None if device_aug else pkg.simple_widerface_train_pipeline,
        num_workers=1, max_boxes_per_image=6, image_dtype=np.uint8 if device_aug else np.float32)
    seed_fn(11)
    return [b for _ in range(2) for b in loader]


@pytest.mark.parametrize("device_aug", [False, True], ids=["host", "device_aug"])
def test_data_loader_gives_lfdtpus_batches(device_aug):
    jb = _loader(jdata, _samples(jdata, seed=3), device_aug, jax_set_random_seed)
    tb = _loader(tdata, _samples(tdata, seed=3), device_aug, set_random_seed)
    assert len(jb) == len(tb) == 2 * 3
    for a, b in zip(jb, tb):
        assert set(a) == set(b)
        for k in ("gt_bboxes", "gt_labels", "gt_mask", "aug_scale", "aug_translation",
                  "aug_flip"):
            if k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        for (ba, la), (bb, lb) in zip(a["annotations"], b["annotations"]):
            assert np.array_equal(ba, bb) and np.array_equal(la, lb)
        assert a["meta"] == b["meta"]
        # host path: normalized (x - 127.5) / 127.5, so one uint8 step is 1/127.5
        unit = 1.0 if device_aug else 1 / 127.5
        diff = np.abs(a["images"].astype(np.float64) - b["images"].astype(np.float64)).max()
        assert diff <= LSB * unit + 1e-6


def test_loader_worker_error_reaches_the_consumer():
    ds = _MemDataset([dict(image=np.zeros((8, 8, 3), np.uint8), bboxes=[[1, 1, 4, 4]],
                           bbox_labels=[0])] * 2 + [dict(no_image=True)] * 2)
    loader = tdata.DataLoader(ds, tdata.RandomDatasetSampler(ds, batch_size=4, seed=0),
                              tdata.IdleRegionSampler(), num_workers=1)
    with pytest.raises(RuntimeError, match="data loader worker failed"):
        list(loader)


def _shm_loader(pkg, ds, num_slots):
    region = pkg.DeviceAugRegionSampler(
        pkg.RandomBBoxCropRegionSampler(crop_size=32, resize_range=(0.6, 1.5)))
    return pkg.ShmDataLoader(ds, pkg.RandomDatasetSampler(ds, batch_size=4, seed=9), region,
                             num_workers=1, max_boxes_per_image=4, num_slots=num_slots)


def test_shm_loader_slots_recycled_only_after_the_copy():
    """A ShmDataLoader with 2 slots, 6 batches an epoch, two epochs, through
    prefetch_to_device, against the same loader and seed read batch by batch
    (copy, then release): a slot released before its copy would be
    overwritten by a later batch. No yielded tensor shares memory with a
    slot, each batch's slot is released once, and every slot is back at the
    end of each epoch."""
    ds = _MemDataset(_samples(tdata, n=24, seed=4))
    keys = ("images", "gt_bboxes", "gt_labels", "gt_mask") + tdata.AUG_KEYS
    ref_loader = _shm_loader(tdata, ds, num_slots=2)
    set_random_seed(5)
    ref = []
    try:
        for _ in range(2):
            for batch in ref_loader:
                ref.append({k: np.array(batch[k]) for k in keys})
                ref_loader.release_slot(batch)
    finally:
        ref_loader.close()
    loader = _shm_loader(tdata, ds, num_slots=2)
    released = []
    release = loader.release_slot
    loader.release_slot = lambda batch: (released.append(batch["_slot"]), release(batch))
    set_random_seed(5)
    got = []
    try:
        for _ in range(2):
            got += list(prefetch_to_device(loader, "cpu", size=2, keys=keys))
            assert loader._free_slots.qsize() == loader.num_slots
        shm = np.frombuffer(loader._shm.buf, np.uint8)
        for a, b in zip(got, ref):
            for k in keys:
                t = a[k].numpy()
                assert not np.shares_memory(t, shm), k
                assert np.array_equal(t, b[k]), k
        del shm, t
    finally:
        loader.close()
    assert len(got) == len(ref) == 12 and len(released) == 12


def _first_batches(pkg, seed_fn, n=2):
    ds = _MemDataset(_samples(pkg, n=24, seed=4))
    loader = _shm_loader(pkg, ds, num_slots=3)
    seed_fn(5)
    try:
        out = []
        for batch in loader:
            out.append(np.array(batch["aug_scale"]))
            loader.release_slot(batch)
        return np.stack(out)
    finally:
        loader.close()


def test_process_workers_honor_the_seed():
    """ROADMAP F11: CPython reseeds `random` in a forked child, so lfdtpu's
    process workers draw a new stream every run whatever the seed; the
    port's workers seed themselves from the parent's stream."""
    port = [_first_batches(tdata, set_random_seed) for _ in range(2)]
    assert np.array_equal(port[0], port[1])
    ref = [_first_batches(jdata, jax_set_random_seed) for _ in range(2)]
    assert not np.array_equal(ref[0], ref[1])
