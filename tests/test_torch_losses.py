# Every loss of the port against lfdtpu's on the CPU, through the configured
# loss objects, from seeded numpy inputs: forward within 1e-6 relative (the
# same float32 elementwise math; sums in another order), and gradients
# within 1e-5 (max|err|/max|ref|) for focal (against jax.grad through
# lfdtpu's custom VJP, the reference CUDA backward), IoU, QFL and CE.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu.ops import loss_wrappers as JW
from lfdtpu.ops import losses as JL
from lfdtpu_torch.ops import loss_wrappers as TW
from lfdtpu_torch.ops import losses as TL

torch.set_num_threads(1)

N, C = 40, 3
FWD_TOL, GRAD_TOL = 1e-6, 1e-5


def max_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def boxes_pair(rng):
    xy = rng.uniform(0, 50, (N, 2))
    pred = np.concatenate([xy, xy + rng.uniform(1, 30, (N, 2))], -1)
    tgt = pred + rng.normal(0, 4, (N, 4))
    tgt[:, 2:] = np.maximum(tgt[:, 2:], tgt[:, :2] + 0.5)
    tgt[0] = pred[0]  # identical boxes: the CIoU guard
    tgt[1] = [200, 200, 210, 210]  # disjoint: IoU clamped at eps
    return pred.astype(np.float32), tgt.astype(np.float32)


def cases():
    """name -> (port loss, lfdtpu loss, pred, target, weight)."""
    rng = np.random.RandomState(0)
    logits = rng.normal(0, 3, (N, C)).astype(np.float32)
    logits[0, 0] = 40.0  # saturated sigmoid: the FLT_MIN clamp
    labels = rng.randint(0, C + 1, N).astype(np.int32)  # C = background
    row_w = (rng.rand(N) > 0.2).astype(np.float32)
    score = rng.rand(N).astype(np.float32)
    soft = rng.rand(N, C).astype(np.float32)
    pred_b, tgt_b = boxes_pair(rng)
    reg = rng.normal(0, 1, (N, 4)).astype(np.float32)
    reg_t = rng.normal(0, 1, (N, 4)).astype(np.float32)
    dfl_pred = rng.normal(0, 1, (N, 8)).astype(np.float32)
    dfl_t = rng.uniform(0, 6.99, N).astype(np.float32)
    return {
        "focal": ("FocalLoss", dict(gamma=2.0, alpha=0.25), logits, labels, row_w),
        "qfl": ("QualityFocalLoss", dict(beta=2.0, loss_weight=2.0), logits,
                (labels, score), row_w),
        "dfl": ("DistributionFocalLoss", {}, dfl_pred, dfl_t, row_w),
        "ce": ("CrossEntropyLoss", {}, rng.normal(0, 2, (N, C + 1)).astype(np.float32),
               labels, row_w),
        "bce": ("BCEWithLogitsLoss", {}, logits, soft, row_w[:, None]),
        "iou": ("IoULoss", dict(eps=1e-6), pred_b, tgt_b, row_w),
        "giou": ("GIoULoss", {}, pred_b, tgt_b, row_w),
        "diou": ("DIoULoss", {}, pred_b, tgt_b, row_w),
        "ciou": ("CIoULoss", {}, pred_b, tgt_b, row_w),
        "iou_w4": ("IoULoss", {}, pred_b, tgt_b, np.repeat(row_w[:, None], 4, 1)),
        "smooth_l1": ("SmoothL1Loss", dict(beta=0.5), reg, reg_t, row_w[:, None]),
        "l1": ("L1Loss", {}, reg, reg_t, row_w[:, None]),
        "mse": ("MSELoss", {}, reg, reg_t, row_w[:, None]),
    }


CASES = cases()


def to_jax(x):
    return tuple(map(jnp.asarray, x)) if isinstance(x, tuple) else jnp.asarray(x)


def to_torch(x):
    return tuple(map(torch.from_numpy, x)) if isinstance(x, tuple) else torch.from_numpy(x)


def both(name, reduction, avg_factor):
    cls, kw, pred, target, weight = CASES[name]
    jl = getattr(JW, cls)(reduction=reduction, **kw)
    tl = getattr(TW, cls)(reduction=reduction, **kw)

    def jf(p):
        return jl(p, to_jax(target), weight=jnp.asarray(weight), avg_factor=avg_factor)

    tp = torch.from_numpy(pred).requires_grad_()
    got = tl(tp, to_torch(target), weight=torch.from_numpy(weight), avg_factor=avg_factor)
    return jf, pred, tp, got


@pytest.mark.parametrize("reduction,avg_factor", [("mean", None), ("mean", 17.0),
                                                  ("sum", None), ("none", None)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_forward_matches_lfdtpu(name, reduction, avg_factor):
    jf, pred, _, got = both(name, reduction, avg_factor)
    ref = np.asarray(jf(jnp.asarray(pred)))
    assert got.shape == ref.shape
    assert np.isfinite(ref).all()
    assert max_rel(got.detach().numpy(), ref) <= FWD_TOL


@pytest.mark.parametrize("name", ["focal", "iou", "qfl", "ce", "iou_w4"])
def test_loss_gradient_matches_lfdtpu(name):
    jf, pred, tp, got = both(name, "mean", 11.0)
    got.backward()
    ref = np.asarray(jax.grad(jf)(jnp.asarray(pred)))
    assert np.abs(ref).max() > 0
    assert max_rel(tp.grad.numpy(), ref) <= GRAD_TOL


def test_focal_backward_is_the_reference_formula():
    # saturated logits: the forward's FLT_MIN clamp has zero derivative, but
    # the reference CUDA backward (and lfdtpu's VJP) keep a gradient there
    logits = np.array([[-120.0, 0.5], [120.0, -0.5]], np.float32)
    labels = np.array([0, 2], np.int32)
    tp = torch.from_numpy(logits).requires_grad_()
    TL.sigmoid_focal_loss(tp, torch.from_numpy(labels), reduction="sum").backward()
    ref = jax.grad(lambda p: JL.sigmoid_focal_loss(p, jnp.asarray(labels),
                                                   reduction="sum"))(jnp.asarray(logits))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(ref), rtol=GRAD_TOL, atol=1e-12)
    assert tp.grad[0, 0] < 0  # pushed up, though the clamped forward is flat


def test_weight_reduce_loss_semantics():
    loss = torch.arange(1.0, 7.0).reshape(3, 2)
    w = torch.tensor([[1.0], [0.0], [2.0]])
    assert float(TL.weight_reduce_loss(loss, w, "mean", avg_factor=4.0)) == (1 + 2 + 10 + 12) / 4
    assert float(TL.weight_reduce_loss(loss, w, "sum")) == 25.0
    assert float(TL.weight_reduce_loss(loss, None, "mean")) == 3.5
    assert torch.equal(TL.weight_reduce_loss(loss, w, "none", avg_factor=4.0), loss * w)
    with pytest.raises(ValueError, match="avg_factor"):
        TL.weight_reduce_loss(loss, w, "sum", avg_factor=4.0)
    with pytest.raises(ValueError, match="reduction"):
        TL.weight_reduce_loss(loss, None, "max")


def test_loss_objects_carry_lfdtpu_names_and_defaults():
    for name in ("FocalLoss", "QualityFocalLoss", "DistributionFocalLoss",
                 "CrossEntropyLoss", "BCEWithLogitsLoss", "SmoothL1Loss", "L1Loss",
                 "MSELoss", "IoULoss", "GIoULoss", "DIoULoss", "CIoULoss"):
        j, t = getattr(JW, name)(), getattr(TW, name)()
        assert type(t).__name__ == name
        assert {k: getattr(t, k) for k in j.__dataclass_fields__} == \
            {k: getattr(j, k) for k in j.__dataclass_fields__}
    assert TW.INDEPENDENT_REGRESSION_LOSSES == JW.INDEPENDENT_REGRESSION_LOSSES
    assert TW.UNION_REGRESSION_LOSSES == JW.UNION_REGRESSION_LOSSES
