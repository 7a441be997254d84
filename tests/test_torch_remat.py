# make_train_step(remat=True) of the port (the net's forward under
# torch.utils.checkpoint) on the CPU:
#   - two steps against lfdtpu's remat step (tests/test_parallel.py:95's
#     setting: tests/test_detector.py::tiny_lfd, batch 4 at 64x64, SGD
#     momentum 0.9, clip 10, lr 0.01) on carried weights, at the tolerances
#     of tests/test_torch_train_step.py: float32 within STEP_TOL (metrics,
#     params, BN stats); bf16 (mixed_precision) losses within 5%, lfdtpu
#     casting the whole forward to bf16 and the port running it under
#     autocast;
#   - the remat step equals the port's plain step bit for bit, float32 and
#     bf16, BN running_mean, running_var and num_batches_tracked included:
#     the recomputation in backward does not update the BN statistics a
#     second time, which torch.utils.checkpoint alone does.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from lfdtpu.execution.optim import SGD as JaxSGD
from lfdtpu.parallel.data_parallel import create_train_state as jax_create_train_state
from lfdtpu.parallel.data_parallel import make_train_step as jax_make_train_step
from lfdtpu_torch.execution import SGD
from lfdtpu_torch.execution.jax_convert import jax_variables_to_state_dict
from lfdtpu_torch.models import LFD, LFDHead, LFDResNet, SimpleNeck
from lfdtpu_torch.ops.loss_wrappers import FocalLoss, IoULoss
from lfdtpu_torch.parallel import create_train_state, make_train_step
from tests.test_detector import tiny_lfd
from tests.test_torch_train_step import check_metrics, check_state

torch.set_num_threads(1)

HW = (64, 64)
LR, CLIP = 0.01, 10.0
BF16_LOSS_TOL = 0.05  # tests/test_torch_train_step.py::test_bf16_step_loss_stays_near_fp32


def batch(B=4):
    """tests/test_parallel.py::_mk_batch with its seed."""
    images = np.random.RandomState(0).rand(B, 64, 64, 3).astype(np.float32)
    gt = np.zeros((B, 4, 4), np.float32)
    gt[:, 0] = [8, 8, 24, 24]
    labels = np.zeros((B, 4), np.int32)
    mask = np.zeros((B, 4), bool)
    mask[:, 0] = True
    return images, gt, labels, mask


def port_tiny(variables):
    """The port's twin of tiny_lfd with lfdtpu's variables (strict)."""
    bn = dict(type="BatchNorm2d")
    bb = LFDResNet(block_mode="fastest", stem_mode="fastest", body_mode=None,
                   stem_channels=16, body_architecture=(1, 1), body_channels=(16, 32),
                   out_indices=((0, 0), (1, 0)), norm_cfg=bn)
    strides = tuple(bb.num_output_strides_list)
    neck = SimpleNeck(bb.num_output_channels_list, 32, strides, norm_cfg=bn)
    head = LFDHead(1, 2, 32, num_head_channels=32, num_conv_layers=1,
                   norm_cfg=dict(type="GroupNorm", num_groups=8), share_head_flag=True,
                   merge_path_flag=True)
    det = LFD(backbone=bb, neck=neck, head=head, num_classes=1,
              regression_ranges=((0, 32), (32, 64)), point_strides=strides,
              classification_loss_func=FocalLoss(), regression_loss_func=IoULoss(),
              distance_to_bbox_mode="sigmoid")
    det.net.load_state_dict(jax_variables_to_state_dict(variables, det.net), strict=True)
    return det


def jax_steps(**kw):
    """lfdtpu's tiny_lfd: its initial variables and its state and metrics
    after two steps of make_train_step(**kw)."""
    det = tiny_lfd()
    opt = JaxSGD(momentum=0.9)
    state = jax_create_train_state(det, opt, jax.random.PRNGKey(0), HW)
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    step = jax_make_train_step(det, opt, HW, clip_max_norm=CLIP, donate=False, **kw)
    args = tuple(map(jnp.asarray, batch())) + (jnp.float32(LR), jnp.bool_(True))
    metrics = []
    for _ in range(2):
        state, m = step(state, *args)
        metrics.append({k: float(v) for k, v in m.items()})
    return det, variables, jax.device_get(state), metrics


def port_steps(variables, **kw):
    det = port_tiny(variables)
    state = create_train_state(det, SGD(momentum=0.9), device="cpu")
    step = make_train_step(det, state.optimizer, HW, clip_max_norm=CLIP, **kw)
    metrics = [step(*batch(), LR, True) for _ in range(2)]
    return det, metrics


def test_remat_steps_match_lfdtpu():
    jdet, variables, jstate, jmetrics = jax_steps(remat=True)
    tdet, metrics = port_steps(variables, remat=True)
    for got, ref in zip(metrics, jmetrics):
        check_metrics(got, ref)
    check_state(tdet, jdet, variables, jstate)


def test_remat_mixed_precision_steps_match_lfdtpu():
    _, variables, _, jmetrics = jax_steps(remat=True, mixed_precision=True)
    tdet, metrics = port_steps(variables, remat=True, mixed_precision=True)
    for got, ref in zip(metrics, jmetrics):
        assert np.isfinite(float(got["loss"]))
        assert abs(float(got["loss"]) - ref["loss"]) <= BF16_LOSS_TOL * abs(ref["loss"]), \
            (float(got["loss"]), ref["loss"])
    assert all(p.dtype == torch.float32 for p in tdet.net.parameters())
    assert float(metrics[1]["loss"]) < float(metrics[0]["loss"]) * 1.5  # lfdtpu's check


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_remat_step_equals_the_plain_step(mixed_precision):
    _, variables, _, _ = jax_steps()
    plain, plain_metrics = port_steps(variables, mixed_precision=mixed_precision)
    remat, remat_metrics = port_steps(variables, remat=True, mixed_precision=mixed_precision)
    for a, b in zip(plain_metrics, remat_metrics):
        assert all(torch.equal(a[k], b[k]) for k in a), (a, b)
    ref = plain.net.state_dict()
    for k, v in remat.net.state_dict().items():
        assert torch.equal(v, ref[k]), k
    tracked = [v for k, v in ref.items() if k.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == 2 for v in tracked)  # two steps, one update each


def test_checkpoint_alone_updates_the_bn_stats_twice():
    """The hazard the remat step guards against: a plain non-reentrant
    checkpoint of the train-mode net recomputes it in backward, and every
    BatchNorm counts (and folds in) that batch a second time."""
    _, variables, _, _ = jax_steps()
    det = port_tiny(variables).net.train()
    x = torch.from_numpy(batch()[0])
    sum(o.sum() for o in checkpoint(det, x, use_reentrant=False)).backward()
    tracked = [int(v) for k, v in det.state_dict().items() if k.endswith("num_batches_tracked")]
    assert tracked and all(n == 2 for n in tracked)
