# The port's optimizers, clip and schedules against lfdtpu's on the CPU:
#   - SGD / GroupedSGD (torch.optim.SGD with param groups) against lfdtpu's
#     torch-semantics SGD over 3 steps with momentum and weight decay, from
#     seeded numpy gradients: rtol 1e-6 (the same float32 updates);
#   - clip_by_global_norm with the gate on and off, and global_norm counting
#     each shared-head parameter once;
#   - the schedules equal lfdtpu's at every iteration of a 250-iteration
#     warmup + milestone sweep (exact: the same Python float math).
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from lfdtpu import zoo as jax_zoo
from lfdtpu.execution import optim as JO
from lfdtpu.execution import schedules as JS
from lfdtpu_torch import zoo as torch_zoo
from lfdtpu_torch.execution import optim as TO
from lfdtpu_torch.execution import schedules as TS
from lfdtpu_torch.models.layers import BatchNorm2d, Scale

torch.set_num_threads(1)


class Tiny(nn.Module):
    """A conv with a bias, a conv into a BatchNorm and a Scale: one parameter
    of each kind the bias / main split sees."""

    def __init__(self):
        super().__init__()
        self.head = nn.Conv2d(3, 4, 3, bias=True)
        self.body = nn.Conv2d(4, 4, 1, bias=False)
        self.norm = BatchNorm2d(4)
        self.scale = Scale(1.0)


# port parameter name -> lfdtpu param path (flax naming, so that
# bias_param_labels sees conv biases and norm affines as lfdtpu does)
NAMES = {
    "head.weight": ("Conv_0", "kernel"), "head.bias": ("Conv_0", "bias"),
    "body.weight": ("Conv_1", "kernel"),
    "norm.weight": ("BatchNorm_0", "scale"), "norm.bias": ("BatchNorm_0", "bias"),
    "scale._scale": ("scale0", "scale"),
}


def to_tree(named):
    tree = {}
    for name, a in named.items():
        mod, leaf = NAMES[name]
        tree.setdefault(mod, {})[leaf] = jnp.asarray(a)
    return tree


def from_tree(tree):
    return {name: np.asarray(tree[mod][leaf]) for name, (mod, leaf) in NAMES.items()}


@pytest.mark.parametrize("kind", ["sgd", "sgd_nesterov", "grouped"])
def test_sgd_matches_lfdtpu_over_three_steps(kind):
    torch.manual_seed(0)
    net = Tiny()
    if kind == "grouped":
        jopt = JO.GroupedSGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                             bias_lr=0.2, bias_weight_decay=0.0)
        topt = TO.GroupedSGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                             bias_lr=0.2, bias_weight_decay=0.0)
    else:
        nesterov = kind == "sgd_nesterov"
        jopt = JO.SGD(0.1, momentum=0.9, weight_decay=1e-4, nesterov=nesterov)
        topt = TO.SGD(0.1, momentum=0.9, weight_decay=1e-4, nesterov=nesterov)
    opt = topt.build(net)
    named = dict(net.named_parameters())
    params = to_tree({k: p.detach().numpy().copy() for k, p in named.items()})
    state = jopt.init(params)
    rng = np.random.RandomState(1)
    for lr in (0.05, 0.1, 0.02):
        grads = {k: rng.normal(0, 1, p.shape).astype(np.float32) for k, p in named.items()}
        for k, p in named.items():
            p.grad = torch.from_numpy(grads[k])
        TO.set_lr(opt, lr)
        opt.step()
        updates, state = jopt.update(to_tree(grads), state, params, jnp.float32(lr))
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    ref = from_tree(params)
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
        buf = opt.state[p]["momentum_buffer"].numpy()
        mod, leaf = NAMES[k]
        np.testing.assert_allclose(buf, np.asarray(state.momentum_buf[mod][leaf]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_grouped_sgd_bias_group_is_every_conv_bias():
    net = Tiny()
    opt = TO.GroupedSGD(learning_rate=0.1, bias_lr=0.3).build(net)
    main, bias = opt.param_groups
    assert [id(p) for p in bias["params"]] == [id(net.head.bias)]
    assert len(main["params"]) == 5
    TO.set_lr(opt, 0.01)
    assert main["lr"] == 0.01 and bias["lr"] == pytest.approx(0.03)


@pytest.mark.parametrize("scale,enabled", [(10.0, True), (10.0, False), (0.01, True)])
def test_clip_by_global_norm_matches_lfdtpu(scale, enabled):
    rng = np.random.RandomState(2)
    grads = [rng.normal(0, scale, s).astype(np.float32) for s in ((3, 4), (5,), ())]
    jclipped, jnorm = JO.clip_by_global_norm([jnp.asarray(g) for g in grads], 5.0,
                                             jnp.bool_(enabled))
    tgrads = [torch.from_numpy(g.copy()) for g in grads]
    tnorm = TO.clip_by_global_norm(tgrads, 5.0, enabled)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for t, j in zip(tgrads, jclipped):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    # the gate as a device tensor works the same, with no host sync
    tgrads = [torch.from_numpy(g.copy()) for g in grads]
    TO.clip_by_global_norm(tgrads, 5.0, torch.tensor(enabled))
    for t, j in zip(tgrads, jclipped):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    clipped = float(TO.global_norm(tgrads))
    assert clipped == pytest.approx(min(float(jnorm), 5.0) if enabled else float(jnorm),
                                    rel=1e-5)


def test_global_norm_counts_the_shared_head_once():
    net = torch_zoo.ZOO["WIDERFACE-L"]().net
    unique = list(net.parameters())
    every = list(net.named_parameters(remove_duplicate=False))
    assert len(every) > len(unique)  # the head is registered at every level
    for p in unique:
        p.grad = torch.ones_like(p)
    n_unique = sum(p.numel() for p in unique)
    assert float(TO.global_norm([p.grad for p in unique])) == pytest.approx(n_unique ** 0.5)
    # lfdtpu holds one copy of the shared head: the same element count
    jparams = jax.eval_shape(lambda: jax_zoo.ZOO["WIDERFACE-L"]().init(
        jax.random.PRNGKey(0), (64, 64)))["params"]
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jparams)) == n_unique


WARM = dict(by_epoch=False, warmup_mode="linear", warmup_loops=200, warmup_ratio=0.1)


@pytest.mark.parametrize("make", [
    lambda S: S.MultiStepLRSchedule(0.1, (5, 15, 20), 0.1, S.WarmupSetting(**WARM)),
    lambda S: S.MultiStepLRSchedule(0.1, (3, 9), 0.5, S.WarmupSetting(
        by_epoch=True, warmup_mode="exp", warmup_loops=4, warmup_ratio=0.2)),
    lambda S: S.MultiStepLRSchedule(0.05, (10,), 0.1, S.WarmupSetting(
        False, "constant", 30, 0.3)),
    lambda S: S.ConstantLRSchedule(0.02, S.WarmupSetting(**WARM)),
    lambda S: S.CosineLRSchedule(0.1, 250, 0.001, S.WarmupSetting(**WARM)),
    lambda S: S.MultiStepLRSchedule(0.1, (2,)),
], ids=["multistep-linear", "multistep-exp-by-epoch", "multistep-constant", "constant",
        "cosine", "no-warmup"])
def test_schedule_matches_lfdtpu_at_every_iteration(make):
    jsched, tsched = make(JS), make(TS)
    for it in range(250):
        epoch = it // 10  # 10 iterations per epoch: milestones fall mid-sweep
        assert tsched(epoch, it) == jsched(epoch, it), (epoch, it)
