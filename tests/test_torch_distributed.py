# Data parallelism of the port (lfdtpu_torch.parallel) on the CPU, two
# processes over gloo, against lfdtpu's mesh step:
#   - local_batch_slice and ShardedDatasetSampler give lfdtpu's rows for the
#     same arguments, and default to the process group's rank and size;
#   - the train step over two ranks of 4 rows each equals lfdtpu's
#     make_train_step(mesh=make_mesh(jax.devices()[:2])) on the same 8 rows
#     and the port's one-process step on them: the global loss and num_pos,
#     every parameter and the BN running statistics after two steps, at
#     lfdtpu's own tolerance (rtol 1e-4, atol 1e-6, tests/test_parallel.py:
#     52-53). Weights come from lfdtpu through the bridge, inputs from a
#     numpy seed. Cases: lfd (tests/test_detector.py::tiny_lfd), lfdv2 with
#     the classification and regression weights on (the weight-sum
#     normalizers), lfdv2q (reg_w and score-target sums), fcos with a frozen
#     stem and stage (find_unused_parameters), an lfd batch whose positives
#     all sit on rank 0 (rank 1's share of every normalizer is 0), and remat
#     (the recomputation all-reduces the BN moments again inside the
#     backward), all in float64 (ROADMAP F8: BatchNorm over few values
#     amplifies float32 rounding); and bf16 autocast in float32, against the
#     port's one-process bf16 step (lfdtpu casts the whole net to bf16,
#     tests/test_torch_remat.py): the metrics at RTOL / ATOL, the state no
#     farther from the one-process fp32 step than BF16_BAND times the
#     one-process bf16 step is (see assert_run_equal).
#   - make_eval_step(mesh) returns the global outputs lfdtpu's sharded eval
#     step returns (tests/test_parallel.py:57).
# The ranks are fresh processes (`python -m tests.test_torch_distributed
# RANK WORLD PORT JOB OUT`) that import no jax; one pair runs every case.
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 64)
B, NMAX = 8, 6
LRS = (0.01, 0.02)
CLIP = 10.0
RTOL, ATOL = 1e-4, 1e-6  # lfdtpu's, tests/test_parallel.py:52-53
BF16_BAND = 2.0  # bf16: the two-rank step's distance from fp32 over one process's
CHILD_TIMEOUT = 120
CASES = {  # name: (detector kind, dtype, mixed_precision, remat, positives on rank 0 only)
    "lfd": ("lfd", "float64", False, False, False),
    "lfdv2_weighted": ("lfdv2", "float64", False, False, False),
    "lfdv2q": ("lfdv2q", "float64", False, False, False),
    "fcos_frozen_stage": ("fcos", "float64", False, False, False),
    "lfd_positives_on_rank0": ("lfd", "float64", False, False, True),
    "lfd_remat": ("lfd", "float64", False, True, False),
    "lfd_bf16": ("lfd", "float32", True, False, False),
}
NUM_CLASSES = {"lfd": 1, "lfdv2": 1, "lfdv2q": 1, "fcos": 3}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(module, job, out_dir, world=2):
    """`python -m tests.<module> RANK WORLD PORT JOB OUT` for every rank at
    once; each must exit 0 within CHILD_TIMEOUT. Returns each rank's
    torch.load(OUT/rank{r}.pt)."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", f"tests.{module}", str(r), str(world),
                               str(port), str(job), str(out_dir)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def join_group(rank, world, port):
    import torch.distributed as dist

    from lfdtpu_torch.parallel import initialize_distributed

    initialize_distributed("gloo", f"tcp://127.0.0.1:{port}", int(world), int(rank))
    assert dist.get_backend() == "gloo"


# ------------------------------------------------------ the port's detectors

def port_detector(kind):
    """The port's tiny detectors (no jax): tests/test_detector.py::tiny_lfd
    as LFD, LFDv2 (with the classification and regression weights) and
    LFDv2Q on its parts, and tests/test_torch_fcos.py::tiny_pair's FCOS with
    frozen_stages=1."""
    from lfdtpu_torch.models import (FCOS, LFD, FCOSHead, LFDHead, LFDResNet, LFDv2, LFDv2Q,
                                     SimpleNeck)
    from lfdtpu_torch.ops.loss_wrappers import FocalLoss, IoULoss, QualityFocalLoss

    bn = dict(type="BatchNorm2d")
    bb = LFDResNet(block_mode="fastest", stem_mode="fastest", body_mode=None,
                   stem_channels=16, body_architecture=(1, 1), body_channels=(16, 32),
                   out_indices=((0, 0), (1, 0)), norm_cfg=bn,
                   frozen_stages=1 if kind == "fcos" else -1)
    strides = tuple(bb.num_output_strides_list)
    neck = SimpleNeck(bb.num_output_channels_list, 32, strides, norm_cfg=bn)
    if kind == "fcos":
        return FCOS(bb, neck, FCOSHead(3, 32, num_heads=2, num_head_channels=32, num_layers=1),
                    classification_loss_func=FocalLoss(), regression_loss_func=IoULoss(),
                    num_classes=3, regression_ranges=((0, 32), (32, 1e8)),
                    point_strides=strides)
    head = LFDHead(1, 2, 32, num_head_channels=32, num_conv_layers=1,
                   norm_cfg=dict(type="GroupNorm", num_groups=8), share_head_flag=True,
                   merge_path_flag=True)
    cls, extra = {"lfd": (LFD, {}),
                  "lfdv2": (LFDv2, dict(enable_classification_weight=True,
                                        enable_regression_weight=True)),
                  "lfdv2q": (LFDv2Q, {})}[kind]
    return cls(backbone=bb, neck=neck, head=head, num_classes=1,
               regression_ranges=((0, 32), (32, 64)), point_strides=strides,
               classification_loss_func=(QualityFocalLoss() if kind == "lfdv2q"
                                         else FocalLoss()),
               regression_loss_func=IoULoss(),
               distance_to_bbox_mode="exp" if kind == "lfdv2q" else "sigmoid", **extra)


def make_batch(kind, positives_on_rank0=False, seed=3):
    """8 seeded images and GT padded to NMAX: 1-5 boxes of 4-48 px an
    image over the kind's classes; with positives_on_rank0, rows 4-7 (rank
    1's) hold no box."""
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1.0, 1.0, (B,) + HW + (3,)).astype(np.float32)
    gt = np.zeros((B, NMAX, 4), np.float32)
    labels = np.zeros((B, NMAX), np.int32)
    mask = np.zeros((B, NMAX), bool)
    for b in range(B // 2 if positives_on_rank0 else B):
        for k in range(1 + b % 5):
            w, h = rng.uniform(4, 48, 2)
            gt[b, k] = (rng.uniform(0, HW[1] - w), rng.uniform(0, HW[0] - h), w, h)
            labels[b, k] = rng.randint(NUM_CLASSES[kind])
            mask[b, k] = True
    return images, gt, labels, mask


def port_run(kind, state_dict, batch, dtype, mixed_precision, remat, mesh=None):
    """Two SGD steps (momentum 0.9, wd 1e-4, clip 10) of the port's step
    from state_dict on `batch` (this rank's rows under a mesh): the metrics
    of each step (floats) and the final state_dict (numpy)."""
    from lfdtpu_torch.execution import SGD
    from lfdtpu_torch.parallel import create_train_state, make_train_step

    det = port_detector(kind)
    det.net.load_state_dict(state_dict, strict=True)
    det.net.to(getattr(torch, dtype))
    state = create_train_state(det, SGD(momentum=0.9, weight_decay=1e-4), device="cpu",
                               mesh=mesh)
    step = make_train_step(det, state.optimizer, HW, clip_max_norm=CLIP,
                           mixed_precision=mixed_precision, remat=remat, mesh=mesh)
    images = batch[0].astype(dtype)
    metrics = [{k: float(v) for k, v in step(images, *batch[1:], lr, True).items()}
               for lr in LRS]
    return metrics, {k: v.detach().numpy().copy() for k, v in det.net.state_dict().items()}


def worker(rank, world, port, job_path, out_dir):
    """One rank: its rows of every case's batch through the mesh step, the
    eval step, and the sampler and slice defaults of the process group."""
    from lfdtpu_torch.data import RandomDatasetSampler, ShardedDatasetSampler
    from lfdtpu_torch.parallel import (local_batch_slice, make_eval_step, make_mesh,
                                       process_info, shard_batch)
    from lfdtpu_torch.parallel.data_parallel import TrainState

    join_group(rank, world, port)
    mesh = make_mesh("cpu")
    job = torch.load(job_path, weights_only=False)
    out = dict(info={k: str(v) for k, v in process_info().items()},
               mesh=(mesh.rank, mesh.size, str(mesh.device)),
               slice=local_batch_slice(B), cases={})
    sampler = ShardedDatasetSampler(RandomDatasetSampler(_Indexes(20), batch_size=8, seed=5))
    out["sampler"] = (sampler.get_batch_size(), len(sampler), list(sampler))
    for name, (kind, dtype, mp, remat, _) in CASES.items():
        rows = shard_batch(mesh, *job["batches"][name])
        out["cases"][name] = port_run(kind, job["weights"][kind], [r.numpy() for r in rows],
                                      dtype, mp, remat, mesh)
    det = port_detector("lfd")
    det.net.load_state_dict(job["weights"]["lfd"])
    images = job["batches"]["lfd"][0]
    outs = make_eval_step(det, mesh)(TrainState(det.net, None), shard_batch(mesh, images))
    out["eval"] = [o.numpy() for o in outs]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


class _Indexes:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_indexes(self):
        return list(range(self.n))


# ------------------------------------------------------------- the parent

def jax_detector(kind):
    """lfdtpu's twin of port_detector(kind)."""
    from lfdtpu.models import (FCOS, LFD, FCOSHead, LFDResNet, LFDv2, LFDv2Q, SimpleNeck)
    from lfdtpu.ops.loss_wrappers import FocalLoss, IoULoss, QualityFocalLoss
    from tests.test_detector import tiny_lfd

    if kind == "lfd":
        return tiny_lfd()
    if kind == "fcos":
        bb = LFDResNet(block_mode="fastest", stem_mode="fastest", body_mode=None,
                       stem_channels=16, body_architecture=(1, 1), body_channels=(16, 32),
                       out_indices=((0, 0), (1, 0)), norm_cfg=dict(type="BatchNorm2d"),
                       frozen_stages=1)
        strides = tuple(bb.num_output_strides_list)
        return FCOS(bb, SimpleNeck(num_neck_channels=32, num_input_strides_list=strides,
                                   norm_cfg=dict(type="BatchNorm2d")),
                    FCOSHead(num_classes=3, num_heads=2, num_head_channels=32, num_layers=1,
                             norm_cfg=None),
                    classification_loss_func=FocalLoss(), regression_loss_func=IoULoss(),
                    num_classes=3, regression_ranges=((0, 32), (32, 1e8)),
                    point_strides=strides)
    base = tiny_lfd()
    extra = (dict(enable_classification_weight=True, enable_regression_weight=True)
             if kind == "lfdv2" else {})
    return (LFDv2 if kind == "lfdv2" else LFDv2Q)(
        base.backbone, base.neck, base.head, num_classes=1,
        regression_ranges=base.regression_ranges, point_strides=base.point_strides,
        classification_loss_func=QualityFocalLoss() if kind == "lfdv2q" else FocalLoss(),
        regression_loss_func=IoULoss(),
        distance_to_bbox_mode="exp" if kind == "lfdv2q" else "sigmoid", **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The bridged weights, the batches, the two ranks' results, the port's
    one-process results and lfdtpu's mesh step (where it applies)."""
    import jax

    from lfdtpu_torch.execution.jax_convert import jax_variables_to_state_dict
    from tests.test_torch_bridge import randomize_norms

    weights, variables = {}, {}
    for kind in NUM_CLASSES:
        jdet = jax_detector(kind)
        variables[kind] = randomize_norms(jdet.init(jax.random.PRNGKey(7), HW), 7)
        net = port_detector(kind).net
        weights[kind] = jax_variables_to_state_dict(variables[kind], net)
    batches = {name: make_batch(kind, pos0) for name, (kind, _, _, _, pos0) in CASES.items()}
    tmp = tmp_path_factory.mktemp("ddp")
    torch.save(dict(weights=weights, batches=batches), tmp / "job.pt")
    ranks = run_ranks("test_torch_distributed", tmp / "job.pt", tmp)
    single = {name: port_run(kind, weights[kind], batches[name], dtype, mp, remat)
              for name, (kind, dtype, mp, remat, _) in CASES.items()}
    fp32 = port_run("lfd", weights["lfd"], batches["lfd_bf16"], "float32", False, False)
    return dict(weights=weights, variables=variables, batches=batches, ranks=ranks,
                single=single, fp32=fp32)


def jax_mesh_run(runs, name):
    """lfdtpu's make_train_step over a 2-device mesh, float64, two steps on
    the case's 8 rows: (metrics, final state as a port state_dict)."""
    import jax
    import jax.numpy as jnp

    from lfdtpu.execution import optim as jax_optim
    from lfdtpu.parallel import make_mesh as jax_make_mesh
    from lfdtpu.parallel import shard_batch as jax_shard_batch
    from lfdtpu.parallel.data_parallel import TrainState
    from lfdtpu.parallel.data_parallel import make_train_step as jax_make_train_step
    from lfdtpu_torch.execution.jax_convert import jax_variables_to_state_dict

    kind, dtype, _, remat, _ = CASES[name]
    jdet = jax_detector(kind)
    mesh = jax_make_mesh(jax.devices()[:2])
    with jax.enable_x64(True):
        params, stats = (jax.tree.map(lambda a: jnp.asarray(a, dtype), runs["variables"][kind][k])
                         for k in ("params", "batch_stats"))
        opt = jax_optim.SGD(momentum=0.9, weight_decay=1e-4)
        step = jax_make_train_step(jdet, opt, HW, mesh=mesh, clip_max_norm=CLIP, donate=False,
                                   remat=remat)
        images, gt, labels, mask = runs["batches"][name]
        batch = jax_shard_batch(mesh, images.astype(dtype), gt, labels, mask)
        state, metrics = TrainState(params, stats, opt.init(params)), []
        for lr in LRS:
            state, m = step(state, *batch, jnp.asarray(lr, dtype), jnp.bool_(True))
            metrics.append({k: float(v) for k, v in m.items()})
        state = jax.device_get(state)
    sd = jax_variables_to_state_dict({"params": state.params, "batch_stats": state.batch_stats},
                                     port_detector(kind).net)
    return metrics, {k: v.numpy() for k, v in sd.items()}


def max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def assert_run_equal(got, ref, what, fp32=None, counters=True):
    """Metrics, params and BN statistics within rtol RTOL, atol ATOL.

    With `fp32` (the one-process fp32 run of a bf16 case): under bf16
    autocast a conv's weight gradient leaves its backward rounded to bf16
    (8 bits), each rank's over its 4 rows before the ranks' sum and one
    process's once over the 8, and the BN outputs round to bf16 after
    moments summed in another order. Two bf16 runs then differ by about as
    much as bf16 differs from fp32 (the updates of some convs by 20%
    either way on this case). So both are held to the fp32 run: the
    two-rank run's distance from it at most BF16_BAND times the one-process
    bf16 run's (and RTOL of it): each loss and num_pos, and the worst
    max|err| / max|ref| over the params and statistics. grad_norm, the
    gradients' rounding alone, is left to the params."""
    (gm, gsd), (rm, rsd) = got, ref
    for step, (a, b) in enumerate(zip(gm, rm)):
        for k in b:
            if fp32 is None:
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{what}: step {step} {k}")
            elif k != "grad_norm":
                f = fp32[0][step][k]
                band = max(abs(b[k] - f), RTOL * abs(f))
                assert abs(a[k] - f) <= BF16_BAND * band + ATOL, (what, step, k, a[k], b[k], f)
    assert set(gsd) == set(rsd)
    for k, v in rsd.items():
        if v.dtype.kind != "f":  # num_batches_tracked (lfdtpu keeps none)
            if counters:
                np.testing.assert_array_equal(gsd[k], v, err_msg=f"{what}: {k}")
        elif fp32 is None:
            np.testing.assert_allclose(gsd[k], v, rtol=RTOL, atol=ATOL, err_msg=f"{what}: {k}")
    if fp32 is not None:
        floats = [k for k, v in rsd.items() if v.dtype.kind == "f"]
        got_err = max(max_rel(gsd[k], fp32[1][k]) for k in floats)
        band = max(max_rel(rsd[k], fp32[1][k]) for k in floats)
        assert got_err <= BF16_BAND * max(band, RTOL), (what, got_err, band)


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_equals_the_one_process_step(runs, name):
    rank0, rank1 = (r["cases"][name] for r in runs["ranks"])
    for k, v in rank0[1].items():  # the ranks hold one model
        np.testing.assert_array_equal(v, rank1[1][k], err_msg=k)
    assert rank0[0] == rank1[0]  # and report the global metrics
    assert_run_equal(rank0, runs["single"][name], f"{name}, two ranks against one process",
                     fp32=runs["fp32"] if CASES[name][2] else None)
    if CASES[name][4]:
        assert rank0[0][0]["num_pos"] > 0


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if not c[2]])
def test_two_rank_step_equals_lfdtpus_mesh_step(runs, name):
    ref = jax_mesh_run(runs, name)
    assert_run_equal(runs["ranks"][0]["cases"][name], ref, f"{name}, two ranks against lfdtpu",
                     counters=False)
    assert_run_equal(runs["single"][name], ref, f"{name}, one process against lfdtpu",
                     counters=False)
    if CASES[name][0] == "fcos":  # the frozen stem and stage moved by weight decay alone
        assert "centerness_loss" in ref[0][0]


def test_eval_step_gathers_lfdtpus_sharded_outputs(runs):
    import jax

    from lfdtpu.parallel import make_eval_step as jax_make_eval_step
    from lfdtpu.parallel import make_mesh as jax_make_mesh
    from lfdtpu.parallel import shard_batch as jax_shard_batch
    from lfdtpu.parallel.data_parallel import TrainState

    mesh = jax_make_mesh(jax.devices()[:2])
    v = runs["variables"]["lfd"]
    images = runs["batches"]["lfd"][0]
    ref = jax_make_eval_step(jax_detector("lfd"), mesh)(
        TrainState(v["params"], v["batch_stats"], None), jax_shard_batch(mesh, images))
    for r in runs["ranks"]:
        assert [o.shape for o in r["eval"]] == [(B,) + np.shape(o)[1:] for o in ref]
        for got, want in zip(r["eval"], ref):
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-5)


def test_process_group_defaults(runs):
    from lfdtpu.data import RandomDatasetSampler as JRandomDatasetSampler
    from lfdtpu.data import ShardedDatasetSampler as JShardedDatasetSampler

    for rank, r in enumerate(runs["ranks"]):
        assert r["mesh"] == (rank, 2, "cpu")
        assert r["info"]["process_index"] == str(rank) and r["info"]["process_count"] == "2"
        assert r["slice"] == (4 * rank, 4 * rank + 4)
        ref = JShardedDatasetSampler(JRandomDatasetSampler(_Indexes(20), batch_size=8, seed=5),
                                     rank, 2)
        assert r["sampler"] == (ref.get_batch_size(), len(ref), list(ref))


@pytest.mark.parametrize("args", [(8, 0, 2), (8, 1, 2), (12, 2, 4), (64, 1, 2), (6, 0, 1)])
def test_local_batch_slice_matches_lfdtpu(args):
    from lfdtpu.parallel import local_batch_slice as jax_slice
    from lfdtpu_torch.parallel import local_batch_slice

    assert local_batch_slice(*args) == jax_slice(*args)
    with pytest.raises(AssertionError, match="not divisible"):
        local_batch_slice(args[0] + 1, 0, 2 * args[2])


@pytest.mark.parametrize("index,count", [(0, 2), (1, 2), (3, 4)])
def test_sharded_sampler_matches_lfdtpu(index, count):
    from lfdtpu.data import RandomWithNegDatasetSampler as JSampler
    from lfdtpu.data import ShardedDatasetSampler as JSharded
    from lfdtpu_torch.data import RandomWithNegDatasetSampler, ShardedDatasetSampler

    class _Set(_Indexes):
        def __getitem__(self, i):
            return {"bboxes": [[0, 0, 1, 1]]} if i % 5 else {}

    port = ShardedDatasetSampler(RandomWithNegDatasetSampler(_Set(30), 8, 0.25, seed=2),
                                 index, count)
    ref = JSharded(JSampler(_Set(30), 8, 0.25, seed=2), index, count)
    assert (port.get_batch_size(), len(port)) == (ref.get_batch_size(), len(ref))
    assert list(port) == list(ref)


def test_sharded_sampler_defaults_to_one_process():
    from lfdtpu_torch.data import RandomDatasetSampler, ShardedDatasetSampler

    sampler = RandomDatasetSampler(_Indexes(16), batch_size=4, seed=1)
    sharded = ShardedDatasetSampler(RandomDatasetSampler(_Indexes(16), batch_size=4, seed=1))
    assert sharded.get_batch_size() == 4 and list(sharded) == list(sampler)


if __name__ == "__main__" and len(sys.argv) > 1:
    worker(*sys.argv[1:])
