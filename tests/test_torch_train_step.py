# The port's training path against lfdtpu on the CPU, from seeded numpy
# inputs and the same weights (through the bridge):
#   - two full train steps of WIDERFACE-L, batch 2, against
#     lfdtpu.parallel.make_train_step: loss, grad_norm, every param and every
#     BN running stat, max|err|/max|ref| <= 1e-4, at 64x64 (its stride-64
#     level is 1x1) in float64 and at 128x128 in float32, plus one float32
#     step at 64x64 (see below why);
#   - jax_train_state_to_port continues a JAX run step for step;
#   - BatchNorm's running variance (F5), predict on a net left in train()
#     (F6), frozen_stages / norm_eval, and the bf16 autocast step.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu import zoo as jax_zoo
from lfdtpu.execution import optim as jax_optim
from lfdtpu.execution.torch_convert import convert_reference_state_dict
from lfdtpu.parallel.data_parallel import TrainState as JaxTrainState
from lfdtpu.parallel.data_parallel import make_train_step as jax_make_train_step
from lfdtpu_torch import zoo as torch_zoo
from lfdtpu_torch.execution import (SGD, MultiStepLRSchedule, WarmupSetting,
                                    jax_train_state_to_port)
from lfdtpu_torch.execution.jax_convert import jax_variables_to_state_dict
from lfdtpu_torch.models.layers import BatchNorm2d
from lfdtpu_torch.parallel import create_train_state, make_train_step
from tests.test_torch_bridge import randomize_norms

torch.set_num_threads(1)

HW = (64, 64)
# the WIDERFACE workload's schedule at its first two iterations (linear
# warmup from 0.1 * 0.1 over 200 iterations, `_common.py:138-158`)
SCHEDULE = MultiStepLRSchedule(0.1, (500, 700, 900), 0.1,
                               WarmupSetting(False, "linear", 200, 0.1))
LRS = (SCHEDULE(0, 0), SCHEDULE(0, 1))
CLIP = 10.0
STEP_TOL = 1e-4  # max|err| / max|ref|: fp32 convs summed in another order


def max_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def make_batch(seed, B=2, nmax=6, num_classes=1, hw=HW):
    """Seeded images and padded GT: boxes of several sizes (some span two
    levels' ranges, so gray bands fire), padded rows, and one label per
    class index in range."""
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1.0, 1.0, (B,) + hw + (3,)).astype(np.float32)
    gt = np.zeros((B, nmax, 4), np.float32)
    labels = np.zeros((B, nmax), np.int32)
    mask = np.zeros((B, nmax), bool)
    for b in range(B):
        n = 3 + b
        for k in range(n):
            w, h = rng.uniform(4, 48, 2)
            x, y = rng.uniform(0, hw[1] - w), rng.uniform(0, hw[0] - h)
            gt[b, k] = (x, y, w, h)
            labels[b, k] = rng.randint(num_classes)
            mask[b, k] = True
    return images, gt, labels, mask


def port_detector(name, variables):
    tdet = torch_zoo.ZOO[name]()
    tdet.net.load_state_dict(jax_variables_to_state_dict(variables, tdet.net), strict=True)
    return tdet


def port_to_jax_tree(tdet, jdet, variables):
    sd = {k: v.detach().contiguous().numpy() for k, v in tdet.net.state_dict().items()}
    return convert_reference_state_dict(sd, jdet, variables)


# ------------------------------------------------------ two full train steps
#
# At 64x64 with batch 2, BatchNorm on the 1x1 level normalizes two values per
# channel. flax computes that variance as E[x^2] - E[x]^2, which in float32
# loses most digits when the two values nearly agree, and the backward
# amplifies it: from one and the same state, the two frameworks' fp32
# gradients of the early convs differ by up to ~1% and grad_norm by ~3e-4.
# So the two-step check at 64x64 runs both frameworks in float64, where they
# agree to ~1e-9 (any difference in the math shows); fp32 is held at 64x64
# for one step (F5 at the 1x1 level) and for two steps at 128x128 (2x2).

@functools.cache
def jax_variables(hw):
    jdet = jax_zoo.ZOO["WIDERFACE-L"]()
    return jdet, randomize_norms(jdet.init(jax.random.PRNGKey(1), hw), 1)


@functools.cache
def jax_run(hw, dtype):
    """WIDERFACE-L, batch 2: lfdtpu's state before, after one and after two
    steps (SGD momentum 0.9, wd 1e-4, clip 10) in `dtype`, with metrics."""
    jdet, variables = jax_variables(hw)
    with jax.enable_x64(dtype == "float64"):
        params, stats = (jax.tree.map(lambda a: jnp.asarray(a, dtype), variables[k])
                         for k in ("params", "batch_stats"))
        opt = jax_optim.SGD(momentum=0.9, weight_decay=1e-4)
        step = jax_make_train_step(jdet, opt, hw, clip_max_norm=CLIP, donate=False)
        images, gt, labels, mask = make_batch(0, hw=hw)
        batch = (jnp.asarray(images, dtype),) + tuple(map(jnp.asarray, (gt, labels, mask)))
        states, metrics = [JaxTrainState(params, stats, opt.init(params))], []
        for lr in LRS:
            s, m = step(states[-1], *batch, jnp.asarray(lr, dtype), jnp.bool_(True))
            states.append(jax.device_get(s))
            metrics.append({k: float(v) for k, v in m.items()})
    return jdet, variables, states, metrics


def port_state(variables, hw, dtype="float32"):
    tdet = port_detector("WIDERFACE-L", variables)
    tdet.net.to(getattr(torch, dtype))
    state = create_train_state(tdet, SGD(momentum=0.9, weight_decay=1e-4), device="cpu")
    step = make_train_step(tdet, state.optimizer, hw, clip_max_norm=CLIP)
    return tdet, state, step


def check_state(tdet, jdet, variables, jstate):
    got = port_to_jax_tree(tdet, jdet, variables)
    for tree, ref in (("params", jstate.params), ("batch_stats", jstate.batch_stats)):
        flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
        flat_got = dict(jax.tree_util.tree_flatten_with_path(got[tree])[0])
        assert len(flat_ref) == len(flat_got)
        for path, a in flat_ref:
            err = max_rel(flat_got[path], a)
            assert err <= STEP_TOL, (tree, jax.tree_util.keystr(path), err)


def check_metrics(got, ref):
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.ndim == 0
        assert max_rel(float(v), ref[k]) <= STEP_TOL, (k, float(v), ref[k])


def run_port(hw, dtype, steps):
    jdet, variables, jstates, jmetrics = jax_run(hw, dtype)
    tdet, _, step = port_state(variables, hw, dtype)
    images, gt, labels, mask = make_batch(0, hw=hw)
    images = images.astype(dtype)
    for lr, ref in zip(LRS[:steps], jmetrics):
        check_metrics(step(images, gt, labels, mask, lr, True), ref)
    assert jmetrics[0]["grad_norm"] > CLIP  # the first step clipped
    check_state(tdet, jdet, variables, jstates[steps])


@pytest.mark.parametrize("hw,dtype", [((64, 64), "float64"), ((128, 128), "float32")])
def test_two_train_steps_match_lfdtpu(hw, dtype):
    run_port(hw, dtype, steps=2)


def test_one_fp32_step_at_a_1x1_level_matches_lfdtpu():
    run_port(HW, "float32", steps=1)


def test_jax_train_state_to_port_continues_the_run():
    hw = (128, 128)
    jdet, variables, jstates, jmetrics = jax_run(hw, "float32")
    tdet, state, step = port_state(variables, hw)
    jax_train_state_to_port(state, jstates[1])
    check_state(tdet, jdet, variables, jstates[1])
    check_metrics(step(*make_batch(0, hw=hw), LRS[1], True), jmetrics[1])
    check_state(tdet, jdet, variables, jstates[2])


def test_jax_train_state_to_port_is_strict():
    _, variables, jstates, _ = jax_run((128, 128), "float32")
    _, state, _ = port_state(variables, (128, 128))
    s1 = jstates[1]
    bufs = jax.tree.map(lambda a: a, s1.opt_state.momentum_buf)
    del bufs["head"]["scale0"]
    with pytest.raises(KeyError, match="scale0"):
        jax_train_state_to_port(state, s1.replace(opt_state=jax_optim.SGDState(bufs)))
    bufs = jax.tree.map(lambda a: a, s1.opt_state.momentum_buf)
    bufs["head"]["scale9"] = {"scale": np.float32(0.0)}
    with pytest.raises(ValueError, match="unmapped JAX leaves"):
        jax_train_state_to_port(state, s1.replace(opt_state=jax_optim.SGDState(bufs)))
    with pytest.raises(ValueError, match="momentum_buf"):
        jax_train_state_to_port(state, s1.replace(opt_state=()))


def test_bf16_step_loss_stays_near_fp32():
    _, variables = jax_variables(HW)
    batch = make_batch(0)
    losses = {}
    for mp in (False, True):
        tdet = port_detector("WIDERFACE-L", variables)
        state = create_train_state(tdet, SGD(momentum=0.9, weight_decay=1e-4), device="cpu")
        step = make_train_step(tdet, state.optimizer, HW, clip_max_norm=CLIP,
                               mixed_precision=mp)
        losses[mp] = [float(step(*batch, lr, True)["loss"]) for lr in LRS]
        assert all(p.dtype == torch.float32 for p in tdet.net.parameters())
        assert all(b.dtype == torch.float32 for b in tdet.net.buffers()
                   if b.is_floating_point())
    for fp32, bf16 in zip(losses[False], losses[True]):
        assert abs(bf16 - fp32) <= 0.05 * abs(fp32), losses


# -------------------------------------------------------------- F5, F6, frozen

def test_batchnorm_running_var_is_biased_as_flax():
    import flax.linen as fnn

    x = np.random.RandomState(0).normal(size=(2, 1, 1, 3)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tbn = BatchNorm2d(3, eps=1e-5, momentum=0.1).train()
    ty = tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), 0.9 + 0.1 * x.var(axis=(0, 1, 2)),
                               rtol=1e-6)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y),
                               rtol=1e-4, atol=1e-4)
    assert int(tbn.num_batches_tracked) == 1


def test_predict_on_a_net_in_train_mode_uses_eval_and_keeps_stats():
    _, variables = jax_variables(HW)
    tdet = port_detector("WIDERFACE-L", variables)
    image = (np.random.RandomState(4).rand(60, 70, 3) * 255).astype(np.uint8)
    rows_eval = tdet.predict_for_single_image(image, classification_threshold=0.05)
    before = {k: v.clone() for k, v in tdet.net.state_dict().items()}
    tdet.net.train()
    rows_train = tdet.predict_for_single_image(image, classification_threshold=0.05)
    assert tdet.net.training  # the mode is left as it was found
    for k, v in tdet.net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert len(rows_eval) > 0
    assert rows_train == rows_eval


@pytest.mark.parametrize("frozen_stages,norm_eval", [(1, False), (0, True)])
def test_frozen_stages_and_norm_eval(frozen_stages, norm_eval):
    _, variables = jax_variables(HW)
    tdet = port_detector("WIDERFACE-L", variables)
    bb = tdet.net._backbone
    bb.frozen_stages, bb.norm_eval = frozen_stages, norm_eval
    state = create_train_state(tdet, SGD(momentum=0.9), device="cpu")  # no weight decay
    frozen = [bb._stem] if frozen_stages > 0 else []
    frozen += bb.stages()[:frozen_stages]
    frozen_params = {id(p) for m in frozen for p in m.parameters()}
    bn_stats = {k: v.clone() for k, v in bb.state_dict().items() if "running" in k}
    before = {id(p): p.detach().clone() for p in bb.parameters()}
    step = make_train_step(tdet, state.optimizer, HW, clip_max_norm=CLIP)
    for lr in LRS:
        step(*make_batch(0), lr, True)
    for p in bb.parameters():
        if id(p) in frozen_params:
            assert torch.equal(p, before[id(p)])
    # live stages train (not stage 4: at 1x1 with batch 2, the two-sample
    # BNs after it pass it (numerically) zero gradient)
    for stage in bb.stages()[frozen_stages:-1]:
        for m in stage.modules():
            if isinstance(m, torch.nn.Conv2d):
                assert not torch.equal(m.weight, before[id(m.weight)])
    for k, v in bb.state_dict().items():
        if k in bn_stats:
            frozen_bn = norm_eval or k.startswith("_stem") or k.startswith("stage0")
            assert torch.equal(v, bn_stats[k]) == frozen_bn, k
    assert all(not m.training for m in frozen)
