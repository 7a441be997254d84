# Every loader of the port hands out its batches in the sampler's order,
# whatever order its workers finish them in (ROADMAP F21). The datasets here
# sleep longer for earlier batches, by a fixed rule of the index, so that
# with several workers the later batches finish first:
#   - two gloo ranks (fresh processes, tests/test_torch_distributed.py::
#     run_ranks), each sharding a loader of 4 workers as the Executor does
#     (DataLoader with threads, DataLoader with processes, ShmDataLoader):
#     at every step of two epochs, rank 0's rows followed by rank 1's equal
#     the one-process, one-worker loader's global batch k;
#   - the Executor's val pass over the two ranks, each with its own val
#     loader of 4 workers, equals a one-process pass: each step's image ids
#     and every image's rows (float64 net, the rows within 1e-9);
#   - a ShmDataLoader with num_workers + 2 slots and a slow first batch
#     finishes under a time limit of its own (no deadlock), in order;
#   - a worker's error raises while an earlier batch is still pending, before
#     any batch is handed out.
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import join_group, port_detector, run_ranks

torch.set_num_threads(1)

BATCH, N_BATCHES, WORKERS, EPOCHS = 4, 6, 4, 2
DELAY = 0.03  # seconds a row sleeps for each batch after its own
KINDS = ("threads", "processes", "shm")


class _Slow:
    """n batches of BATCH samples, in sequential batches. Sample i sleeps
    slow(i) seconds, by default DELAY * (n - i // BATCH), so that earlier
    batches take longer. Sample i is an hw image of i's pattern with one box
    and an image_id; the `fail` samples raise."""

    def __init__(self, hw=(8, 8), n=N_BATCHES, slow=None, fail=()):
        self._hw, self._n, self._fail = hw, n, set(fail)
        self._slow = slow or (lambda i: DELAY * (n - i // BATCH))

    def __getitem__(self, i):
        time.sleep(self._slow(i))
        if i in self._fail:
            raise ValueError(f"sample {i} is broken")
        rng = np.random.RandomState(i)
        return dict(image=rng.randint(0, 256, self._hw + (3,)).astype(np.uint8),
                    bboxes=[[1 + i % 3, 2, 4, 3 + i % 2]], bbox_labels=[0], image_id=i + 1)

    def __len__(self):
        return self._n * BATCH

    def get_indexes(self):
        return list(range(len(self)))


def loader(kind, ds, workers=WORKERS, pipeline=None, **kw):
    from lfdtpu_torch import data as tdata

    sampler = tdata.RandomDatasetSampler(ds, batch_size=BATCH, shuffle=False)
    if kind == "shm":
        return tdata.ShmDataLoader(ds, sampler, tdata.IdleRegionSampler(), num_workers=workers,
                                   max_boxes_per_image=4, crop_size=ds[0]["image"].shape[0],
                                   **kw)
    return tdata.DataLoader(ds, sampler, tdata.IdleRegionSampler(), augmentation_pipeline=pipeline,
                            num_workers=workers, max_boxes_per_image=4, image_dtype=np.uint8,
                            use_processes=kind == "processes", **kw)


KEYS = ("images", "gt_bboxes", "gt_labels", "gt_mask")


def epochs(ld, n=EPOCHS):
    """Every batch of n epochs, its KEYS copied out (a slot released)."""
    out = []
    try:
        for _ in range(n):
            for batch in ld:
                out.append({k: np.array(batch[k]) for k in KEYS})
                if "_slot" in batch:
                    ld.release_slot(batch)
    finally:
        ld.close()
    return out


# ------------------------------------------------------------------- ranks

def _val_config(det, val, weights, work_dir):
    import lfdtpu_torch.execution as texe

    return dict(work_dir=str(work_dir), training_epochs=1, seed=0, batch_size=BATCH,
                input_hw=(64, 64), model=det, optimizer=texe.SGD(), device="cpu",
                weight_path=weights, val_data_loader=val)


def val_pass(val, weights, work_dir):
    """One Executor.val() of the float64 tiny LFD over `val`: [(image ids,
    rows)] per step."""
    import lfdtpu_torch.execution as texe

    class Steps(texe.Hook):
        def __init__(self):
            super().__init__()
            self.steps = []

        def after_val_iter(self, executor):
            c = executor.config_dict
            self.steps.append(([m["image_id"] for m in c["eval_meta"]],
                               [np.asarray(r, np.float64) for r in c["eval_results"]]))

    det = port_detector("lfd")
    det.net.double()
    det.classification_threshold = 0.0
    ex = texe.Executor(_val_config(det, val, weights, work_dir))
    hook = Steps()
    ex.register_hook(hook)
    ex.val()
    return hook.steps


def _val_loader(workers):
    from lfdtpu_torch import data as tdata

    return loader("threads", _Slow((64, 64)), workers=workers,
                  pipeline=tdata.Compose([tdata.simple_normalize]))


def worker(rank, world, port, job_path, out_dir):
    from lfdtpu_torch.execution.executor import _shard
    from lfdtpu_torch.parallel import make_mesh

    join_group(rank, world, port)
    job = torch.load(job_path, weights_only=False)
    mesh = make_mesh(torch.device("cpu"))
    out = {}
    for kind in KINDS:
        ld = loader(kind, _Slow())
        _shard(ld, mesh)  # as the Executor shards its train loader
        out[kind] = epochs(ld)
    out["val"] = val_pass(_val_loader(WORKERS), job["weights"],
                          os.path.join(out_dir, f"work{rank}"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loader_order")
    weights = str(tmp / "weights.pth")
    net = port_detector("lfd").net.double()
    torch.save({"state_dict": net.state_dict()}, weights)
    torch.save(dict(weights=weights), tmp / "job.pt")
    ranks = run_ranks("test_torch_loader_order", tmp / "job.pt", tmp)
    ref = epochs(loader("threads", _Slow(), workers=1))
    val = val_pass(_val_loader(1), weights, tmp / "single")
    return dict(ranks=ranks, ref=ref, val=val)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_loaders_hand_out_global_batch_k_at_step_k(runs, kind):
    r0, r1 = (r[kind] for r in runs["ranks"])
    ref = runs["ref"]
    assert len(r0) == len(r1) == len(ref) == EPOCHS * N_BATCHES
    for k, (a, b, want) in enumerate(zip(r0, r1, ref)):
        for key in KEYS:
            got = np.concatenate([a[key], b[key]])
            assert np.array_equal(got, want[key].astype(got.dtype)), (k, key)


def test_val_pass_over_two_ranks_equals_one_process(runs):
    r0, r1 = (r["val"] for r in runs["ranks"])
    ref = runs["val"]
    assert len(r0) == len(ref) == N_BATCHES
    assert [ids for ids, _ in ref] == [list(range(k * BATCH + 1, (k + 1) * BATCH + 1))
                                       for k in range(N_BATCHES)]
    n_rows = 0
    for (ids0, rows0), (ids1, rows1), (ids, rows) in zip(r0, r1, ref):
        assert ids0 == ids1 == ids
        for a, b, c in zip(rows0, rows1, rows):
            assert a.shape == b.shape == c.shape
            assert np.array_equal(a, b)
            if len(c):
                np.testing.assert_allclose(a, c, rtol=1e-9, atol=1e-9)
            n_rows += len(c)
    assert n_rows > 0


# --------------------------------------------------------- one process

def _within(seconds, fn):
    """fn() on a daemon thread: (its result, or the exception it raised),
    or a failure after `seconds`."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except Exception as e:  # handed to the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"not done after {seconds} s: a deadlock"
    return box


def test_shm_loader_with_a_slow_first_batch_does_not_deadlock():
    """2 workers, 4 slots, 10 batches; batch 0 takes a second, the others
    none: the workers fill the three slots after it, then wait for its
    turn. The run ends, in the sampler's order, and every slot is back."""
    ld = loader("shm", _Slow(n=10, slow=lambda i: 1.0 if i < BATCH else 0.0), workers=2)
    assert ld.num_slots == 4
    box = _within(60, lambda: (epochs(ld, 1), ld._free_slots.qsize()))
    assert "error" not in box, box.get("error")
    got, free = box["out"]
    ref = epochs(loader("threads", _Slow(n=10, slow=lambda i: 0.0), workers=1), 1)
    assert free == 4 and len(got) == len(ref) == 10
    for a, b in zip(got, ref):
        assert all(np.array_equal(a[k], b[k]) for k in KEYS)


@pytest.mark.parametrize("kind", KINDS)
def test_worker_error_raises_while_an_earlier_batch_is_pending(kind):
    """Batch 0 takes 3 s, batches 1 and 2 none, and batch 3 fails at its
    last sample after 1.2 s: the first next() raises the error well before
    batch 0 is done, and hands out no batch (not batch 1, ready first)."""
    ds = _Slow(slow=lambda i: 3.0 if i < BATCH else 0.3 if i >= 3 * BATCH else 0.0,
               fail=(4 * BATCH - 1,))
    ld = loader(kind, ds)
    t0 = time.perf_counter()
    try:
        box = _within(30, lambda: next(iter(ld)))
    finally:
        ld.close()
    # no repr of a handed-out batch: its views die with the loader's memory
    assert isinstance(box.get("error"), RuntimeError), sorted(box)
    assert "sample 15 is broken" in str(box["error"])
    assert time.perf_counter() - t0 < 2.5


if __name__ == "__main__" and len(sys.argv) > 1:
    worker(*sys.argv[1:])
