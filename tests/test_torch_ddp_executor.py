# The port's Executor over a data mesh of two ranks (two processes, gloo,
# on the CPU) against lfdtpu's Executor on the conftest mesh and the port's
# one-process Executor: tests/test_detector.py::tiny_lfd (bridged weights,
# float64: ROADMAP F8), 8 seeded 64x64 images, a global batch of 4 (2 rows
# a rank), 2 epochs, a val pass each epoch (val batch 4) with a
# COCOEvaluator, and no random augmentation (the whole image, normalized:
# each loader's own `random` stream would draw differently per rank, as in
# lfdtpu's multi-host runs). Rank 0's final checkpoint and rank 1's weights
# must equal each other and the one-process run's, and lfdtpu's, within
# lfdtpu's rtol 1e-4 / atol 1e-6; every val pass's per-image rows on rank 0
# (each rank decodes its own rows, gathered in the global order) and the
# evaluator's metrics must equal both references'. Only rank 0 writes the
# checkpoints and evaluates.
import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import join_group, port_detector, run_ranks

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6  # lfdtpu's, tests/test_parallel.py:52-53
N_IMAGES, BATCH, EPOCHS = 8, 4, 2


class _Images:
    """8 seeded 64x64 images with one box each and COCO image ids."""

    def __init__(self, pkg):
        rng = np.random.RandomState(2)
        self._samples = {}
        for i in range(N_IMAGES):
            s = pkg.Sample()
            s["image"] = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
            s["image_id"] = i + 1
            s["bboxes"] = [[6 + 3 * i, 8 + 2 * i, 14 + i, 18 - i]]
            s["bbox_labels"] = [0]
            self._samples[i] = s

    def __getitem__(self, i):
        return self._samples[i]

    def __len__(self):
        return len(self._samples)

    def get_indexes(self):
        return list(self._samples)


def annotations(path):
    ds = _Images(type("P", (), {"Sample": dict}))
    with open(path, "w") as f:
        json.dump({
            "images": [{"id": i + 1, "height": 64, "width": 64, "file_name": f"{i}.jpg"}
                       for i in range(N_IMAGES)],
            "annotations": [{"id": i + 1, "image_id": i + 1, "category_id": 1,
                             "bbox": ds[i]["bboxes"][0], "iscrowd": 0,
                             "area": ds[i]["bboxes"][0][2] * ds[i]["bboxes"][0][3]}
                            for i in range(N_IMAGES)],
            "categories": [{"id": 1, "name": "obj"}]}, f)
    return path


def config(pkg, exe, ev, det, work_dir, ann_path, **extra):
    """The same config for either package: a shuffled (seeded) train
    sampler, a sequential val sampler, whole images, one worker each."""
    ds = _Images(pkg)
    pipeline = pkg.Compose([pkg.simple_normalize])
    train = pkg.DataLoader(ds, pkg.RandomDatasetSampler(ds, batch_size=BATCH, shuffle=True,
                                                        seed=0),
                           pkg.IdleRegionSampler(), augmentation_pipeline=pipeline,
                           num_workers=1, max_boxes_per_image=4)
    val = pkg.DataLoader(ds, pkg.RandomDatasetSampler(ds, batch_size=BATCH, shuffle=False,
                                                      seed=0),
                         pkg.IdleRegionSampler(), augmentation_pipeline=pipeline,
                         num_workers=1, max_boxes_per_image=4)
    return dict(
        work_dir=str(work_dir), training_epochs=EPOCHS, display_interval=10, save_interval=1,
        val_interval=1, seed=0, batch_size=BATCH, input_hw=(64, 64), model=det,
        optimizer=exe.SGD(momentum=0.9, weight_decay=1e-4),
        lr_schedule=exe.ConstantLRSchedule(base_lr=0.01),
        optimizer_grad_clip_cfg=dict(max_norm=10, duration=1),
        train_data_loader=train, val_data_loader=val,
        evaluator=ev.COCOEvaluator(ann_path, {0: 1}), **extra)


class _Rows:
    """Every val iteration's rows as this rank's hooks see them."""

    def after_val_iter(self, executor):
        self.rows.append(executor.config_dict["eval_results"])


def _port_trace():
    import lfdtpu_torch.execution as texe

    class Trace(_Rows, texe.Hook):
        def __init__(self):
            super().__init__()
            self.priority, self.rows = texe.Priority.LOWEST, []

    return Trace()


def port_executor(work_dir, job, trace):
    import lfdtpu_torch.data as tdata
    import lfdtpu_torch.evaluation as tev
    import lfdtpu_torch.execution as texe

    det = port_detector("lfd")
    det.net.double()
    det.classification_threshold = job["threshold"]
    ex = texe.Executor(config(tdata, texe, tev, det, work_dir, job["ann"], device="cpu",
                              weight_path=job["weights"]))
    ex.register_hook(trace)
    return ex


def worker(rank, world, port, job_path, out_dir):
    join_group(rank, world, port)
    job = torch.load(job_path, weights_only=False)
    trace = _port_trace()
    work_dir = os.path.join(out_dir, f"work{rank}")
    ex = port_executor(work_dir, job, trace)
    ex.run()
    cfg = ex.config_dict
    torch.save(dict(
        rank=ex.rank, mesh=(ex.mesh.rank, ex.mesh.size), device=str(ex.device),
        loader_batch=cfg["train_data_loader"].batch_size, batch_size=cfg["batch_size"],
        files=sorted(os.listdir(work_dir)), rows=trace.rows,
        state={k: v.numpy() for k, v in ex.state.net.state_dict().items()},
        metrics=cfg["evaluator"].metrics if rank == "0" else None,
        counters=(cfg["epoch"], cfg["train_iter"])),
        os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import lfdtpu.data as jdata
    import lfdtpu.evaluation as jev
    import lfdtpu.execution as jexe
    from lfdtpu_torch.execution.jax_convert import jax_variables_to_state_dict
    from tests.test_detector import tiny_lfd
    from tests.test_torch_bridge import randomize_norms

    tmp = tmp_path_factory.mktemp("ddp_executor")
    ann = annotations(str(tmp / "val.json"))

    class JaxTrace(_Rows, jexe.Hook):
        def __init__(self):
            super().__init__()
            self.priority, self.rows = jexe.Priority.LOWEST, []

    jtrace = JaxTrace()
    jdet = tiny_lfd()
    jdet.classification_threshold = 0.05
    with jax.enable_x64(True):
        jcfg = config(jdata, jexe, jev, jdet, tmp / "jax", ann)
        jex = jexe.Executor(jcfg)
        jex.register_hook(jtrace)  # not in the config: lfdtpu pickles its extra_hooks
        variables = randomize_norms({"params": jex.state.params,
                                     "batch_stats": jex.state.batch_stats}, 3)
        f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        params = f64(variables["params"])
        jex.state = jex.state.replace(params=params, batch_stats=f64(variables["batch_stats"]),
                                      opt_state=jex.optimizer.init(params))
        jex.run()
        jstate = jax.device_get(jex.state)
    weights = str(tmp / "initial.pth")
    net = port_detector("lfd").net
    torch.save({"state_dict": jax_variables_to_state_dict(variables, net)}, weights)
    job = dict(weights=weights, ann=ann, threshold=jdet.classification_threshold)
    torch.save(job, tmp / "job.pt")
    ranks = run_ranks("test_torch_ddp_executor", tmp / "job.pt", tmp)
    strace = _port_trace()
    single = port_executor(tmp / "single", job, strace)
    single.run()
    return dict(
        ranks=ranks, jax_rows=jtrace.rows, jax_metrics=jcfg["evaluator"].metrics,
        jax_state={k: v.numpy() for k, v in jax_variables_to_state_dict(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}, net).items()},
        single_rows=strace.rows, single_metrics=single.config_dict["evaluator"].metrics,
        single_state={k: v.numpy() for k, v in single.state.net.state_dict().items()},
        rank0_ckpt=torch.load(tmp / "work0" / f"epoch_{EPOCHS}.pth", weights_only=True))


def test_ranks_shard_the_batch_and_only_rank0_writes(runs):
    r0, r1 = runs["ranks"]
    assert (r0["mesh"], r1["mesh"]) == ((0, 2), (1, 2))
    assert r0["batch_size"] == r1["batch_size"] == BATCH  # the global batch
    assert r0["loader_batch"] == r1["loader_batch"] == BATCH // 2
    assert r0["counters"] == r1["counters"] == (EPOCHS, EPOCHS * N_IMAGES // BATCH)
    assert [f for f in r0["files"] if f.endswith(".pth")] == [
        f"epoch_{e + 1}.pth" for e in range(EPOCHS)]
    assert not [f for f in r1["files"] if f.endswith(".pth")]
    assert r1["metrics"] is None


def check_state(got, ref, what, counters=True):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=f"{what}: {k}")
        elif counters:
            np.testing.assert_array_equal(got[k], v, err_msg=f"{what}: {k}")


def test_rank0_checkpoint_equals_rank1_and_both_references(runs):
    ckpt = {k: v.numpy() for k, v in runs["rank0_ckpt"]["state_dict"].items()}
    for k, v in runs["ranks"][1]["state"].items():
        np.testing.assert_array_equal(ckpt[k], v, err_msg=k)
    check_state(ckpt, runs["single_state"], "two ranks against one process")
    check_state(ckpt, runs["jax_state"], "two ranks against lfdtpu", counters=False)


def check_rows(got, ref, what):
    assert len(got) == len(ref) == EPOCHS * N_IMAGES // BATCH, what
    for g, r in zip(got, ref):
        assert [len(x) for x in g] == [len(x) for x in r], what
        for a, b in zip(g, r):
            if len(b):
                np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                           rtol=RTOL, atol=1e-5, err_msg=what)


def test_val_rows_and_metrics_equal_both_references(runs):
    rows = runs["ranks"][0]["rows"]
    assert rows == runs["ranks"][1]["rows"]  # every rank holds the gathered rows
    assert sum(len(x) for batch in rows for x in batch) > 0
    check_rows(rows, runs["single_rows"], "two ranks against one process")
    check_rows(rows, runs["jax_rows"], "two ranks against lfdtpu")
    metrics = runs["ranks"][0]["metrics"]
    assert "mAP" in metrics and set(metrics) == set(runs["jax_metrics"])
    for k, v in metrics.items():
        assert abs(v - runs["single_metrics"][k]) <= 1e-6, k
        assert abs(v - runs["jax_metrics"][k]) <= 1e-6, k


if __name__ == "__main__" and len(sys.argv) > 1:
    worker(*sys.argv[1:])
