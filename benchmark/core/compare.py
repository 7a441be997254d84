"""The comparisons that decide `correct`, and the numbers they print.

Served rows: a served frame's rows against the reference's decode of the
same frame. Rounding in a lower precision moves scores and boxes a little
and trades rows at the decode's discrete cuts (the top-k of points, NMS's
IoU threshold, the max_det cut), so each served row is matched in the
reference's candidate pool (every box the detector could emit, before NMS):
the box of its class with the highest IoU, at least MATCH_IOU. Over the rows
of every checked frame:
  box_err    mean squared 1 - IoU of the matched served rows;
  score_err  mean squared |log score - log matched score| of the same;
  row_err    the share of rows in one set and not the other: the served
             rows and the reference's final rows (after NMS and the max_det
             cut) are paired one to one, greedily by IoU, a pair of one
             class overlapping by more than the configuration's NMS
             threshold (one detection in NMS's sense: rounding that keeps a
             neighbour of a cluster instead of its best still pairs); the
             unpaired rows of both sets (added and lost) over all rows of
             both.
How far bf16 rounding alone moves these depends on the seed's weights, so
each is divided by the same measure for the reference computed in bfloat16
(weights and activations rounded, float32 accumulation) on the same frames:
box_gap, score_gap and rows_gap read about 1 for a program that rounds as
bf16 does. box_abs, score_abs: the same with absolute errors, printed.

Train state (train_gaps): the program's first three steps against the
reference's from the same weights and batches:
  loss_gap    |loss - reference loss| / |reference loss| of the first step
              (loss_gap_steps: the widest of the checked steps, printed: on
              a seed whose second step blows the loss up, bf16 rounding
              alone moves the third step's loss by a tenth);
  grad_gap    the first step's clipped gradient, worst leaf:
              | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|);
  change_gap  the parameters' change after the three steps, worst leaf, the
              same measure;
  grad_median, change_median  the same measures' median over the leaves;
  grad_angle, change_angle  1 - the cosine between the program's and the
              reference's first clipped gradients, or changes, over every
              kept leaf: a gap of norms hardly sees noise that does not
              bias a leaf's size, a direction does;
  grad_angle_gap  grad_angle over the same for the reference's first step
              under bfloat16 autocast (as the program's mixed precision):
              about 1 for a program that rounds as bf16 does, whatever the
              seed's batch makes of rounding (one seed in twelve reads ten
              times the others' grad_angle in both).
Leaves whose reference gradient is below a thousandth of the median leaf's
are left out of the leaf measures: their moves are round-off.
"""

from __future__ import annotations

import statistics

import torch

MATCH_IOU = 0.9  # a served row's box against its own point's: bf16 moves it ~1%
ROUND_OFF_LEAF = 1e-3


def rows_to_xyxy(rows):
    """Predict-API rows [label, score, x, y, w, h] (w = x2 - x1 + 1) ->
    (boxes (K, 4) xyxy, scores (K,), labels (K,)) float64/long tensors."""
    if not rows:
        return torch.zeros(0, 4), torch.zeros(0), torch.zeros(0, dtype=torch.long)
    t = torch.tensor(rows, dtype=torch.float64)
    boxes = torch.stack([t[:, 2], t[:, 3], t[:, 2] + t[:, 4] - 1, t[:, 3] + t[:, 5] - 1], -1)
    return boxes, t[:, 1], t[:, 0].long()


def _iou(a, b):
    from ..reference.lfd import iou_matrix

    return iou_matrix(a.double(), b.double())


def _best(a, al, b, bl):
    """For each box of a (labels al): the highest IoU with a box of b of
    the same label, and its index."""
    if not len(a) or not len(b):
        return torch.zeros(len(a), dtype=torch.float64), torch.zeros(len(a), dtype=torch.long)
    return (_iou(a, b) * (al[:, None] == bl[None, :])).max(dim=1)


def _paired(a, al, b, bl, thr):
    """The number of one-to-one pairs of a box of a and one of b of the same
    label overlapping by IoU > thr, paired greedily from the highest IoU."""
    if not len(a) or not len(b):
        return 0
    iou = _iou(a, b) * (al[:, None] == bl[None, :])
    i, j = torch.nonzero(iou > thr, as_tuple=True)
    order = torch.argsort(iou[i, j], descending=True, stable=True)
    used_a, used_b = set(), set()
    for x, y in zip(i[order].tolist(), j[order].tolist()):
        if x not in used_a and y not in used_b:
            used_a.add(x)
            used_b.add(y)
    return len(used_a)


def row_errors(rows, pool, ref_rows, same_iou):
    """Sums over one frame's served `rows` against the reference's
    candidate `pool` and final rows `ref_rows` (dicts of boxes, scores,
    labels): each served row matched to the pool box of its class with the
    highest IoU; a match at IoU >= MATCH_IOU adds its squared and absolute
    1 - IoU and |log score gap|. `unmatched`: the rows of both sets left
    unpaired, served and final rows paired one to one at IoU > same_iou."""
    sb, ss, sl = rows_to_xyxy(rows)
    pb, ps, pl = (pool[k].cpu() for k in ("boxes", "scores", "labels"))
    pb, ps = pb.double(), ps.double()
    rb, rl = ref_rows["boxes"].cpu().double(), ref_rows["labels"].cpu()
    best, at = _best(sb, sl, pb, pl)
    m = best >= MATCH_IOU
    box = 1.0 - best[m]
    score = (ss[m].log() - ps[at[m]].log()).abs()
    return dict(rows=len(ss) + len(rb), matched=int(m.sum()),
                unmatched=len(ss) + len(rb) - 2 * _paired(sb, sl, rb, rl, same_iou),
                box_se=float((box ** 2).sum()), score_se=float((score ** 2).sum()),
                box_ae=float(box.sum()), score_ae=float(score.sum()))


def served_gaps(program, rounded):
    """The numbers of a set of frames: program and rounded are lists of
    row_errors sums over the same frames, of the program's rows and of the
    bfloat16 reference's. box_gap, score_gap: the program's mean squared
    errors over the bf16 reference's (inf when the program matched nothing
    where the reference has rows); box_abs, score_abs: the same for the
    mean absolute errors; rows_gap: the program's unmatched share of rows
    over the bf16 reference's (at least one row's share); unmatched and
    unmatched_bf16: the two shares."""
    def total(errs):
        return {k: sum(e[k] for e in errs) for k in errs[0]}

    p, r = total(program), total(rounded)
    out = {}
    for k in ("box", "score"):
        for kind, name in (("se", f"{k}_gap"), ("ae", f"{k}_abs")):
            if p["matched"]:
                mp = p[f"{k}_{kind}"] / p["matched"]
            else:  # nothing to compare is equal; rows that match nothing are not
                mp = float("inf") if p["rows"] else 0.0
            mr = r[f"{k}_{kind}"] / max(r["matched"], 1)
            out[name] = mp / max(mr, 1e-30)
    out["unmatched"] = p["unmatched"] / max(p["rows"], 1)
    out["unmatched_bf16"] = r["unmatched"] / max(r["rows"], 1)
    out["rows_gap"] = out["unmatched"] / (max(r["unmatched"], 1) / max(r["rows"], 1))
    return out


def decoded_rows(decoded):
    """The reference's decode dict -> predict-API rows."""
    return [[int(l), float(s), float(b[0]), float(b[1]), float(b[2] - b[0] + 1),
             float(b[3] - b[1] + 1)]
            for b, s, l in zip(decoded["boxes"].tolist(), decoded["scores"].tolist(),
                               decoded["labels"].tolist())]


def _leaf_gaps(prog, ref, keep):
    """{leaf: | |prog| - |ref| | / max(|ref|, the median leaf's |ref|)}; a
    leaf the program does not hold reads |prog| = 0."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = statistics.median(norms.values())
    return {k: abs((float(prog[k].double().norm()) if k in prog else 0.0) - norms[k])
            / max(norms[k], med) for k in keep}


def _angle(prog, ref, keep):
    """1 - the cosine between prog and ref over the kept leaves (a leaf the
    program does not hold reads zeros)."""
    p = torch.cat([prog[k].double().flatten() if k in prog
                   else torch.zeros(ref[k].numel(), dtype=torch.float64, device=ref[k].device)
                   for k in keep])
    r = torch.cat([ref[k].double().flatten() for k in keep])
    return 1.0 - float(torch.dot(p, r) / (p.norm() * r.norm()).clamp(min=1e-300))


def train_gaps(prog_losses, ref_losses, prog_grad, ref_grad, prog_change, ref_change,
               rounded_grad=None):
    """{loss_gap, loss_gap_steps, grad_gap, change_gap, grad_median,
    change_median, grad_angle, change_angle} (see the module) and the worst
    leaves' names, with rounded_grad (the bf16 reference's first clipped
    gradient) also grad_angle_gap; each argument a list of floats or a
    {leaf: tensor} dict, the program's leaves named as the reference's."""
    steps = [abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses)]
    norms = {k: float(v.double().norm()) for k, v in ref_grad.items()}
    med = statistics.median(norms.values())
    keep = [k for k, v in norms.items() if v >= ROUND_OFF_LEAF * med]
    grad = _leaf_gaps(prog_grad, ref_grad, keep)
    change = _leaf_gaps(prog_change, ref_change, keep)
    out = dict(loss_gap=steps[0], loss_gap_steps=max(steps), grad_gap=max(grad.values()),
               change_gap=max(change.values()), grad_median=statistics.median(grad.values()),
               change_median=statistics.median(change.values()),
               grad_angle=_angle(prog_grad, ref_grad, keep),
               change_angle=_angle(prog_change, ref_change, keep),
               grad_leaf=max(grad, key=grad.get), change_leaf=max(change, key=change.get),
               left_out=sorted(set(norms) - set(keep)))
    if rounded_grad is not None:
        out["grad_angle_gap"] = out["grad_angle"] / max(_angle(rounded_grad, ref_grad, keep),
                                                        1e-30)
    return out


def _rounded(x, dtype, top):
    """x rounded to the 8-bit float `dtype` under a per-tensor scale (its
    largest magnitude to the format's largest, `top`), back in x's dtype."""
    scale = top / x.detach().abs().max().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """fp8 training's rounding: the value to e4m3 under its own scale, the
    gradient that comes back to e5m2 under the gradient's own scale."""

    @staticmethod
    def forward(ctx, x):
        return _rounded(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, torch.float8_e5m2, 57344.0)


def fp8(x):
    """The control's precision: x in fp8 (see _Fp8), differentiable."""
    return _Fp8.apply(x)
