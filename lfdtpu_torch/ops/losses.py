# Detection losses (`lfdtpu/ops/losses.py`), elementwise torch math.
#
# Numerics follow the reference exactly:
#   - the sigmoid focal loss is the stable log-sigmoid form of the reference
#     CUDA extension
#     (`losses/build/sigmoid_focal_loss/src/cuda/sigmoid_focal_loss_cuda.cu:24-97`)
#     with its FLT_MIN clamp, and its backward is that extension's
#     hand-written formula (`:99-171`), not autograd's derivative of the
#     forward: a torch.autograd.Function, as lfdtpu's custom VJP;
#   - weight / avg_factor semantics mirror `lfd/model/losses/utils.py:8-100`.
#
# Nothing here gathers dynamic index subsets: callers pass full-size tensors
# plus element weights/masks; `sum/avg_factor` over a masked tensor equals
# gather-then-mean, and nothing syncs with the host.

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_FLT_MIN = 1.1754943508222875e-38
_LOG_FLT_MIN = math.log(_FLT_MIN)


def reduce_loss(loss, reduction):
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"invalid reduction: {reduction}")


def weight_reduce_loss(loss, weight=None, reduction="mean", avg_factor=None):
    """`lfd/model/losses/utils.py:28-54` semantics."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == "mean":
        return loss.sum() / avg_factor
    if reduction == "none":
        return loss
    raise ValueError('avg_factor can not be used with reduction="sum"')


# ---------------------------------------------------------------------------
# Sigmoid focal loss (stable form + the reference's backward)
# ---------------------------------------------------------------------------

def _log_sigmoid_neg(x):
    """log(sigmoid(-x)) = log(1 - sigmoid(x)), stable (cuda :49-52)."""
    ge = (x >= 0).to(x.dtype)
    return -x * ge - torch.log1p(torch.exp(x - 2.0 * x * ge))


def _focal_terms(logits, targets):
    """c1 = (t == d) positive-term mask, c2 = (t >= 0 && t != d) negative-term
    mask, for class column d and integer target t (bg = C)."""
    d = torch.arange(logits.shape[-1], device=logits.device, dtype=targets.dtype)[None, :]
    t = targets[:, None]
    return (t == d).to(logits.dtype), ((t >= 0) & (t != d)).to(logits.dtype)


class _SigmoidFocalLoss(torch.autograd.Function):
    """Per-element focal loss (N, C) with SigmoidFocalLossForward's forward
    (cuda :24-59) and SigmoidFocalLossBackward's backward (cuda :99-143)."""

    @staticmethod
    def forward(ctx, logits, targets, gamma, alpha):
        ctx.save_for_backward(logits, targets)
        ctx.gamma, ctx.alpha = gamma, alpha
        c1, c2 = _focal_terms(logits, targets)
        p = torch.sigmoid(logits)
        # (1-p)^g * log(max(p, FLT_MIN))
        term1 = torch.pow(1.0 - p, gamma) * F.logsigmoid(logits).clamp(min=_LOG_FLT_MIN)
        # p^g * log(1-p) in shifted-exp stable form
        term2 = torch.pow(p, gamma) * _log_sigmoid_neg(logits)
        return -c1 * term1 * alpha - c2 * term2 * (1.0 - alpha)

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        gamma, alpha = ctx.gamma, ctx.alpha
        c1, c2 = _focal_terms(logits, targets)
        p = torch.sigmoid(logits)
        logp = F.logsigmoid(logits).clamp(min=_LOG_FLT_MIN)
        d1 = torch.pow(1.0 - p, gamma) * (1.0 - p - p * gamma * logp)
        d2 = torch.pow(p, gamma) * (_log_sigmoid_neg(logits) * (1.0 - p) * gamma - p)
        return (-c1 * d1 * alpha - c2 * d2 * (1.0 - alpha)) * g, None, None, None


def sigmoid_focal_loss(pred, target, weight=None, gamma=2.0, alpha=0.25,
                       reduction="mean", avg_factor=None):
    """`lfd/model/losses/focal_loss.py:40-54`: per-element FL then reduce.

    pred: (N, C) logits; target: (N,) int labels with background == C.
    weight, if given, is per-row and broadcast over classes (`:51-52`).
    """
    loss = _SigmoidFocalLoss.apply(pred, target, float(gamma), float(alpha))
    if weight is not None:
        weight = weight.reshape(-1, 1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


# ---------------------------------------------------------------------------
# Generalized focal losses
# ---------------------------------------------------------------------------

def _bce_with_logits(pred, target):
    # stable binary cross entropy with logits
    return pred.clamp(min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))


def quality_focal_loss(pred, target, weight=None, beta=2.0, reduction="mean",
                       avg_factor=None):
    """QFL (`lfd/model/losses/gfocal_loss.py:10-51`).

    pred: (N, C) logits. target = (label (N,), score (N,)): positives are rows
    with 0 <= label < C and are supervised toward `score` on their label
    column; everything else toward 0, modulated by |score - sigmoid|^beta.
    """
    label, score = target
    C = pred.shape[-1]
    sig = torch.sigmoid(pred)
    neg_loss = _bce_with_logits(pred, torch.zeros_like(pred)) * torch.pow(sig, beta)
    pos_row = (label >= 0) & (label < C)
    onehot = F.one_hot(label.clamp(0, C - 1).long(), C).to(pred.dtype) * pos_row[:, None]
    pos_scale = (score[:, None] - sig).abs()
    pos_loss = (_bce_with_logits(pred, score[:, None].expand(pred.shape))
                * torch.pow(pos_scale, beta))
    loss = torch.where(onehot > 0, pos_loss, neg_loss).sum(dim=1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def distribution_focal_loss(pred, label, weight=None, reduction="mean", avg_factor=None):
    """DFL (`lfd/model/losses/gfocal_loss.py:54-76`)."""
    dis_left = label.to(torch.int64)
    dis_right = dis_left + 1
    weight_left = dis_right.to(pred.dtype) - label
    weight_right = label - dis_left.to(pred.dtype)
    logp = F.log_softmax(pred, dim=-1)
    ce_left = -logp.gather(1, dis_left[:, None])[:, 0]
    ce_right = -logp.gather(1, dis_right[:, None])[:, 0]
    loss = ce_left * weight_left + ce_right * weight_right
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


# ---------------------------------------------------------------------------
# IoU-family losses (aligned xyxy boxes)
# ---------------------------------------------------------------------------

def _overlap(pred, target):
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt).clamp(min=0)
    return wh[..., 0] * wh[..., 1]


def _areas(pred, target):
    ap = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    ag = (target[..., 2] - target[..., 0]) * (target[..., 3] - target[..., 1])
    return ap, ag


def _aligned_iou_parts(pred, target, eps):
    overlap = _overlap(pred, target)
    ap, ag = _areas(pred, target)
    return overlap, ap + ag - overlap + eps


def _enclose_wh(pred, target):
    enc_lt = torch.minimum(pred[..., :2], target[..., :2])
    enc_rb = torch.maximum(pred[..., 2:], target[..., 2:])
    return (enc_rb - enc_lt).clamp(min=0)


def _reduce_iou_weight(weight):
    # (n, 4) weights reduce to (n,) by mean (`iou_loss.py:307-312`)
    if weight is not None and weight.ndim > 1:
        weight = weight.mean(dim=-1)
    return weight


def iou_loss(pred, target, weight=None, eps=1e-6, reduction="mean", avg_factor=None):
    """-log(IoU) (`lfd/model/losses/iou_loss.py:105-123`): union clamped
    >= eps, then IoU clamped >= eps."""
    overlap = _overlap(pred, target)
    ap, ag = _areas(pred, target)
    union = (ap + ag - overlap).clamp(min=eps)
    ious = (overlap / union).clamp(min=eps)
    loss = -torch.log(ious)
    return weight_reduce_loss(loss, _reduce_iou_weight(weight), reduction, avg_factor)


def giou_loss(pred, target, weight=None, eps=1e-7, reduction="mean", avg_factor=None):
    """1 - GIoU (`iou_loss.py:126-169`)."""
    overlap, union = _aligned_iou_parts(pred, target, eps)
    ious = overlap / union
    enc_wh = _enclose_wh(pred, target)
    enclose = enc_wh[..., 0] * enc_wh[..., 1] + eps
    loss = 1.0 - (ious - (enclose - union) / enclose)
    return weight_reduce_loss(loss, _reduce_iou_weight(weight), reduction, avg_factor)


def _center_distance_sq(pred, target):
    left = ((target[..., 0] + target[..., 2]) - (pred[..., 0] + pred[..., 2])) ** 2 / 4
    right = ((target[..., 1] + target[..., 3]) - (pred[..., 1] + pred[..., 3])) ** 2 / 4
    return left + right


def diou_loss(pred, target, weight=None, eps=1e-7, reduction="mean", avg_factor=None):
    """1 - DIoU (`iou_loss.py:172-228`)."""
    overlap, union = _aligned_iou_parts(pred, target, eps)
    ious = overlap / union
    enc_wh = _enclose_wh(pred, target)
    c2 = enc_wh[..., 0] ** 2 + enc_wh[..., 1] ** 2 + eps
    loss = 1.0 - (ious - _center_distance_sq(pred, target) / c2)
    return weight_reduce_loss(loss, _reduce_iou_weight(weight), reduction, avg_factor)


def ciou_loss(pred, target, weight=None, eps=1e-7, reduction="mean", avg_factor=None):
    """1 - CIoU (`iou_loss.py:231-289`), including its v**2/(1-iou+v) form."""
    overlap, union = _aligned_iou_parts(pred, target, eps)
    ious = overlap / union
    enc_wh = _enclose_wh(pred, target)
    c2 = enc_wh[..., 0] ** 2 + enc_wh[..., 1] ** 2 + eps
    rho2 = _center_distance_sq(pred, target)
    w1 = pred[..., 2] - pred[..., 0]
    h1 = pred[..., 3] - pred[..., 1] + eps
    w2 = target[..., 2] - target[..., 0]
    h2 = target[..., 3] - target[..., 1] + eps
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    # lfdtpu guards the aspect-consistency denominator: for identical boxes
    # f32 rounds ious to exactly 1 and v to 0, making the raw form 0/0
    cious = ious - (rho2 / c2 + v ** 2 / (1.0 - ious + v).clamp(min=eps))
    loss = 1.0 - cious
    return weight_reduce_loss(loss, _reduce_iou_weight(weight), reduction, avg_factor)


# ---------------------------------------------------------------------------
# Classification / regression basics
# ---------------------------------------------------------------------------

def cross_entropy_loss(pred, label, weight=None, reduction="mean", avg_factor=None):
    """Softmax CE over C(+1 bg) channels (`cross_entropy_loss.py:12-22`)."""
    logp = F.log_softmax(pred, dim=-1)
    loss = -logp.gather(1, label[:, None].long())[:, 0]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def binary_cross_entropy_loss(pred, label, weight=None, reduction="mean", avg_factor=None):
    """Multi-label BCE on soft targets (`bce_with_logits_loss.py:28-45`)."""
    loss = _bce_with_logits(pred, label.to(pred.dtype))
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def smooth_l1_loss(pred, target, weight=None, beta=1.0, reduction="mean", avg_factor=None):
    """`smooth_l1_loss.py:11-28`."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def l1_loss(pred, target, weight=None, reduction="mean", avg_factor=None):
    return weight_reduce_loss((pred - target).abs(), weight, reduction, avg_factor)


def mse_loss(pred, target, weight=None, reduction="mean", avg_factor=None):
    return weight_reduce_loss((pred - target) ** 2, weight, reduction, avg_factor)
