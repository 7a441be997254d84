"""Plain reference of Deformable DETR-R50 (two-stage, iterative box
refinement), for the benchmark's checks.

Written from the published description: Zhu et al., "Deformable DETR:
Deformable Transformers for End-to-End Object Detection" (ICLR 2021), as
mmdetection v2.28.2 sets it out in
`configs/deformable_detr/deformable_detr_twostage_refine_r50_16x2_50e_coco.py`
(with mmcv 1.x's MultiScaleDeformableAttention, MultiheadAttention and FFN):
a pytorch-style ResNet-50 with every BatchNorm in eval mode, tapped at
C3-C5; a ChannelMapper to 256 (1x1 conv + GroupNorm(32) a level, a 4th level
by a 3x3/s2 conv + GroupNorm(32) on C5, no activation); sine positions over
the padding mask plus a level embedding; 6 encoder layers of multi-scale
deformable self-attention (8 heads, 4 levels, 4 points) and an FFN of 1024,
post-norm; the two-stage proposals and the top 300 tokens by the class-0
logit; 6 decoder layers (self-attention over the queries, deformable
cross-attention from 4-d reference boxes, FFN), each refining the boxes;
the top 100 of the last layer's 300 x 80 sigmoid scores. Plain PyTorch
functions in float32 over a dict of named weights (the names of the
program's state_dict), with no kernels, no cache and no batching tricks. It
imports nothing of the program under test, and runs with TF32 off.

Its route is independent of the program's: the deformable sampling is an
explicit 4-tap bilinear gather (the program's is F.grid_sample), attention
is softmax(Q K^T / sqrt(32)) V written out (the program's is
F.scaled_dot_product_attention), the selections are stable sorts (the
program's are top-k).

Parts:
  param_specs(cfg)        every weight's name, shape and how it is drawn;
  forward(w, cfg, x, hw)  raw NHWC frames and their valid extents -> the
                          last layer's class logits (B, 300, 80), boxes
                          (B, 300, 4) cxcywh of the valid extent, and the
                          selected tokens (B, 300);
  decode(...)             one image's outputs -> final rows and the pool of
                          every (query, class) box the row comparison
                          matches in.

Where it departs from mmdetection (each where the program departs too):
dropout is left out (inference); the two-stage selection reads class 0 of
cls_branches[6] alone, in float32, and reg_branches[6] runs on the selected
tokens only (the same rows). `dtype` computes the net in bfloat16 (weights
and activations rounded, float32 accumulation) with the sampling locations,
the reference boxes, the softmaxes, the sine embeddings and the scores in
float32, as the program's bf16 engine keeps them; `quant` (a callable on
tensors) rounds each conv's and Linear's input and weight (the benchmark's
control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .fcos import (EXPANSION, GN_EPS, _bn, _bn_act, _conv, _conv2d, _gn, normalize, stage_plan,
                   tap_channels)

LN_EPS = 1e-5
PROPOSAL_SIZE = 0.05
PROPOSAL_LIMITS = (0.01, 0.99)
INVERSE_SIGMOID_EPS = 1e-5
POS_FEATS, TEMPERATURE, POS_OFFSET, POS_EPS = 128, 10000.0, -0.5, 1e-6


# ------------------------------------------------------------------ structure

def _linear_spec(specs, name, cout, cin, kind="linear", bias_kind=None):
    specs += [(f"{name}.weight", (cout, cin), kind),
              (f"{name}.bias", (cout,), bias_kind or kind + "_bias")]


def _ln(specs, name, c):
    specs += [(f"{name}.weight", (c,), "norm_weight"), (f"{name}.bias", (c,), "norm_bias")]


def _msda_spec(specs, name, t):
    d, nh, lv, pt = t["embed_dims"], t["heads"], t["levels"], t["points"]
    _linear_spec(specs, f"{name}.sampling_offsets", nh * lv * pt * 2, d, "offsets")
    _linear_spec(specs, f"{name}.attention_weights", nh * lv * pt, d, "attn_weights")
    _linear_spec(specs, f"{name}.value_proj", d, d)
    _linear_spec(specs, f"{name}.output_proj", d, d)


def _ffn_spec(specs, name, t):
    _linear_spec(specs, f"{name}.layers.0", t["ffn_channels"], t["embed_dims"])
    _linear_spec(specs, f"{name}.layers.2", t["embed_dims"], t["ffn_channels"])


def param_specs(cfg):
    """[(name, shape, kind)] of every weight and buffer, in the program's
    state_dict names. kinds: conv (the backbone), neck_conv, linear (+
    linear_bias), offsets (+ offsets_bias: the directional grid),
    attn_weights (+ _bias), cls (+ cls_bias: the prior), reg_final (+ _bias),
    level_embed, norm_weight, norm_bias, running_mean, running_var,
    count."""
    specs = []
    base = cfg["backbone"]["base_channels"]
    _conv(specs, "_backbone.conv1", base, 3, 7)
    _bn(specs, "_backbone.bn1", base)
    for s, blocks in stage_plan(cfg):
        for j, (cin, planes, _, down) in enumerate(blocks):
            p = f"_backbone.layer{s}.{j}"
            for k, (ci, co, ks) in enumerate(((cin, planes, 1), (planes, planes, 3),
                                              (planes, planes * EXPANSION, 1)), 1):
                _conv(specs, f"{p}.conv{k}", co, ci, ks)
                _bn(specs, f"{p}.bn{k}", co)
            if down:
                _conv(specs, f"{p}.downsample.0", planes * EXPANSION, cin, 1)
                _bn(specs, f"{p}.downsample.1", planes * EXPANSION)
    t, n = cfg["transformer"], cfg["neck"]
    d = t["embed_dims"]
    chans = tap_channels(cfg)
    for i, cin in enumerate(chans):
        _conv(specs, f"_neck.lateral{i}.0", d, cin, 1, "neck_conv")
        _gn(specs, f"_neck.lateral{i}.1", d)
    for j in range(n["num_outputs"] - len(chans)):
        _conv(specs, f"_neck.extra{j}.0", d, chans[-1] if j == 0 else d, 3, "neck_conv")
        _gn(specs, f"_neck.extra{j}.1", d)
    specs.append(("level_embeds", (t["levels"], d), "level_embed"))
    for i in range(t["encoder_layers"]):
        p = f"encoder.{i}"
        _msda_spec(specs, f"{p}.attn", t)
        _ln(specs, f"{p}.norm1", d)
        _ffn_spec(specs, f"{p}.ffn", t)
        _ln(specs, f"{p}.norm2", d)
    _linear_spec(specs, "enc_output", d, d)
    _ln(specs, "enc_output_norm", d)
    _linear_spec(specs, "pos_trans", 2 * d, 2 * d)
    _ln(specs, "pos_trans_norm", 2 * d)
    for i in range(t["decoder_layers"]):
        p = f"decoder.{i}"
        _linear_spec(specs, f"{p}.self_attn.in_proj", 3 * d, d)
        _linear_spec(specs, f"{p}.self_attn.out_proj", d, d)
        _ln(specs, f"{p}.norm1", d)
        _msda_spec(specs, f"{p}.cross_attn", t)
        _ln(specs, f"{p}.norm2", d)
        _ffn_spec(specs, f"{p}.ffn", t)
        _ln(specs, f"{p}.norm3", d)
    for k in range(t["decoder_layers"] + 1):
        _linear_spec(specs, f"cls_branches.{k}", cfg["num_classes"], d, "cls")
        _linear_spec(specs, f"reg_branches.{k}.0", d, d)
        _linear_spec(specs, f"reg_branches.{k}.2", d, d)
        _linear_spec(specs, f"reg_branches.{k}.4", 4, d, "reg_final")
    return specs


# ------------------------------------------------------------------- layers

def _lin(x, w, name, quant=None, rows=None):
    """x @ W.T + b of the Linear `name` (rows: a slice of its outputs)."""
    W, b = w[f"{name}.weight"], w[f"{name}.bias"]
    if rows is not None:
        W, b = W[rows], b[rows]
    if quant is not None:
        x, W = quant(x), quant(W)
    return F.linear(x, W, b)


def _layer_norm(x, w, name):
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], LN_EPS)


def backbone(w, cfg, x, quant=None):
    """ResNet-50, pytorch style (the stride on each bottleneck's 3x3), every
    BatchNorm on its running statistics: the tapped blocks' outputs."""
    x = _bn_act(_conv2d(x, w["_backbone.conv1.weight"], stride=2, quant=quant), w,
                "_backbone.bn1")
    x = F.max_pool2d(x, 3, 2, 1)
    feats, tapped = [], {tuple(t) for t in cfg["backbone"]["out_indices"]}
    for s, blocks in stage_plan(cfg):
        for j, (_, _, stride, down) in enumerate(blocks):
            p = f"_backbone.layer{s}.{j}"
            out = _bn_act(_conv2d(x, w[f"{p}.conv1.weight"], quant=quant), w, f"{p}.bn1")
            out = _bn_act(_conv2d(out, w[f"{p}.conv2.weight"], stride=stride, quant=quant), w,
                          f"{p}.bn2")
            out = _bn_act(_conv2d(out, w[f"{p}.conv3.weight"], quant=quant), w, f"{p}.bn3",
                          relu=False)
            ident = (_bn_act(_conv2d(x, w[f"{p}.downsample.0.weight"], stride=stride,
                                     quant=quant), w, f"{p}.downsample.1", relu=False)
                     if down else x)
            x = F.relu(out + ident)
            if (s, j) in tapped:
                feats.append(x)
    return feats


def neck(w, cfg, feats, quant=None):
    """ChannelMapper: conv + GroupNorm a level, no activation; the extra
    levels' first on the last input."""
    groups = cfg["neck"]["norm_groups"]

    def conv_gn(name, t, stride=1):
        t = _conv2d(t, w[f"_neck.{name}.0.weight"], stride=stride, quant=quant)
        return F.group_norm(t, groups, w[f"_neck.{name}.1.weight"], w[f"_neck.{name}.1.bias"],
                            GN_EPS)

    outs = [conv_gn(f"lateral{i}", f) for i, f in enumerate(feats)]
    for j in range(cfg["neck"]["num_outputs"] - len(feats)):
        outs.append(conv_gn(f"extra{j}", feats[-1] if j == 0 else outs[-1], 2))
    return outs


def _dim_t(device):
    t = torch.arange(POS_FEATS, dtype=torch.float32, device=device)
    return TEMPERATURE ** (2 * (t // 2) / POS_FEATS)


def _sin_cos(pos):
    return torch.stack((pos[..., 0::2].sin(), pos[..., 1::2].cos()), dim=-1).flatten(-2)


def sine_positions(mask):
    """SinePositionalEncoding(128, normalize=True, offset=-0.5) of a (B, h, w)
    mask (True where padded): (B, h*w, 256), y first."""
    not_mask = 1.0 - mask.float()
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    y = (y + POS_OFFSET) / (y[:, -1:, :] + POS_EPS) * (2 * math.pi)
    x = (x + POS_OFFSET) / (x[:, :, -1:] + POS_EPS) * (2 * math.pi)
    dim_t = _dim_t(mask.device)
    return torch.cat([_sin_cos(y[..., None] / dim_t), _sin_cos(x[..., None] / dim_t)],
                     -1).flatten(1, 2)


def bilinear(v, h, w, loc):
    """v (G, h*w, d) a map's rows (y, x) row-major; loc (G, N, 2) [x, y] with
    the map's extent [0, 1] -> (G, N, d): the four neighbours of (x*w - 0.5,
    y*h - 0.5), weighted by their areas, a neighbour off the map read as 0."""
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    out = 0.0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            tap = torch.gather(v, 1, idx[..., None].expand(-1, -1, v.shape[-1]))
            out = out + tap * (wx * wy * inside)[..., None]
    return out


def deformable_sample(value, shapes, starts, loc, weights):
    """value (B, S, heads, d); loc (B, Q, heads, L, P, 2) float32; weights
    (B, Q, heads, L, P) -> (B, Q, heads * d) float32: each query's samples
    of each level, weighted and summed."""
    B, _, nh, d = value.shape
    _, Q, _, _, P, _ = loc.shape
    v = value.float()
    out = 0.0
    for lvl, ((h, w), st) in enumerate(zip(shapes, starts)):
        vl = v[:, st:st + h * w].permute(0, 2, 1, 3).reshape(B * nh, h * w, d)
        ll = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * nh, Q * P, 2)
        s = bilinear(vl, h, w, ll).view(B * nh, Q, P, d)
        a = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * nh, Q, P, 1)
        out = out + (s * a).sum(2)
    return out.view(B, nh, Q, d).permute(0, 2, 1, 3).reshape(B, Q, nh * d)


def msda(w, name, t, query, value, ref, shapes, starts, mask, quant=None, sample=None):
    """MultiScaleDeformableAttention without its residual. ref (B, Q, L, 2)
    token centres or (B, Q, L, 4) boxes, float32. `sample`: the sampling
    function (default deformable_sample)."""
    B, Q, _ = query.shape
    nh, L, P = t["heads"], t["levels"], t["points"]
    v = _lin(value, w, f"{name}.value_proj", quant).masked_fill(mask[..., None], 0.0)
    v = v.view(B, v.shape[1], nh, -1)
    off = _lin(query, w, f"{name}.sampling_offsets", quant).view(B, Q, nh, L, P, 2).float()
    aw = _lin(query, w, f"{name}.attention_weights", quant).view(B, Q, nh, L * P).float()
    aw = aw.softmax(-1).view(B, Q, nh, L, P)
    r = ref[:, :, None, :, None]
    if ref.shape[-1] == 2:
        norm = torch.tensor([[float(wd), float(h)] for h, wd in shapes], device=query.device)
        loc = r + off / norm[None, None, None, :, None, :]
    else:
        loc = r[..., :2] + off / P * r[..., 2:] * 0.5
    out = (sample or deformable_sample)(v, shapes, starts, loc, aw)
    return _lin(out.to(query.dtype), w, f"{name}.output_proj", quant)


def self_attention(w, name, heads, qk, v, quant=None):
    """softmax(q k^T / sqrt(d)) v a head (float32 scores), then out_proj."""
    B, Q, C = v.shape
    proj = f"{name}.in_proj"
    q = _lin(qk, w, proj, quant, slice(0, C))
    k = _lin(qk, w, proj, quant, slice(C, 2 * C))
    vv = _lin(v, w, proj, quant, slice(2 * C, 3 * C))
    q, k, vv = (t.view(B, Q, heads, -1).transpose(1, 2).float() for t in (q, k, vv))
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), -1)
    out = (att @ vv).transpose(1, 2).reshape(B, Q, C).to(v.dtype)
    return _lin(out, w, f"{name}.out_proj", quant)


def ffn(w, name, x, quant=None):
    return _lin(F.relu(_lin(x, w, f"{name}.layers.0", quant)), w, f"{name}.layers.2", quant)


def inverse_sigmoid(x, eps=INVERSE_SIGMOID_EPS):
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def reg_branch(w, k, x, quant=None):
    p = f"reg_branches.{k}"
    x = F.relu(_lin(x, w, f"{p}.0", quant))
    x = F.relu(_lin(x, w, f"{p}.2", quant))
    return _lin(x, w, f"{p}.4", quant)


def _gather(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


# ------------------------------------------------------------------- forward

def level_masks(frames_hw, valid_hw, shapes, device):
    """Each level's (B, h, w) padding mask: the frame's (True outside its
    valid extent) nearest-downsampled, as mmdetection's F.interpolate."""
    H, W = frames_hw
    rows = torch.arange(H, dtype=torch.float32, device=device)[None, :, None]
    cols = torch.arange(W, dtype=torch.float32, device=device)[None, None, :]
    image = ((rows >= valid_hw[:, 0, None, None]) | (cols >= valid_hw[:, 1, None, None])).float()
    return [F.interpolate(image[None], size=s)[0].bool() for s in shapes]


def forward(w, cfg, frames, valid_hw=None, quant=None, dtype=torch.float32, sample=None,
            refine=True):
    """Raw NHWC frames (B, H, W, 3) and their (B, 2) valid extents (default:
    the whole frame) -> (class logits (B, Q, C), boxes (B, Q, 4) cxcywh of
    the valid extent, float32; the selected tokens (B, Q)). dtype: the net's
    activations (the weights `w` given in it). `sample` replaces the
    deformable sampling and refine=False freezes the reference boxes at the
    proposals (the benchmark's faults)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = cfg["transformer"]
    dev = frames.device
    B, H, W = frames.shape[:3]
    if valid_hw is None:
        valid_hw = torch.tensor([[H, W]] * B, dtype=torch.float32, device=dev)
    valid_hw = valid_hw.float()
    x = normalize(frames, cfg).to(dtype)
    feats = neck(w, cfg, backbone(w, cfg, x, quant), quant)
    shapes = [tuple(f.shape[-2:]) for f in feats]
    starts = [sum(h * wd for h, wd in shapes[:i]) for i in range(len(shapes))]
    masks = level_masks((H, W), valid_hw, shapes, dev)
    src = torch.cat([f.flatten(2).transpose(1, 2) for f in feats], 1)
    pos = torch.cat([sine_positions(m) + w["level_embeds"][lvl].float()
                     for lvl, m in enumerate(masks)], 1).to(dtype)
    mask = torch.cat([m.flatten(1) for m in masks], 1)
    valid_h = torch.stack([(~m[:, :, 0]).sum(1) for m in masks], 1).float()
    valid_w = torch.stack([(~m[:, 0, :]).sum(1) for m in masks], 1).float()
    ratios = torch.stack([valid_w / torch.tensor([float(s[1]) for s in shapes], device=dev),
                          valid_h / torch.tensor([float(s[0]) for s in shapes], device=dev)],
                         -1)  # (B, L, 2)

    centres, proposals = [], []
    for lvl, (h, wd) in enumerate(shapes):
        ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
        xs = torch.arange(wd, dtype=torch.float32, device=dev) + 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        gy, gx = gy.reshape(-1)[None], gx.reshape(-1)[None]
        centres.append(torch.stack([gx / (ratios[:, None, lvl, 0] * wd),
                                    gy / (ratios[:, None, lvl, 1] * h)], -1))
        cx, cy = gx / valid_w[:, lvl, None], gy / valid_h[:, lvl, None]
        size = torch.full_like(cx, PROPOSAL_SIZE * 2.0 ** lvl)
        proposals.append(torch.stack([cx, cy, size, size], -1))
    centres = torch.cat(centres, 1)[:, :, None] * ratios[:, None]

    memory = src
    for i in range(t["encoder_layers"]):
        p = f"encoder.{i}"
        memory = _layer_norm(memory + msda(w, f"{p}.attn", t, memory + pos, memory, centres,
                                           shapes, starts, mask, quant, sample), w, f"{p}.norm1")
        memory = _layer_norm(memory + ffn(w, f"{p}.ffn", memory, quant), w, f"{p}.norm2")

    prop = torch.cat(proposals, 1)
    lo, hi = PROPOSAL_LIMITS
    invalid = ~((prop > lo) & (prop < hi)).all(-1) | mask
    logits = torch.log(prop / (1 - prop)).masked_fill(invalid[..., None], float("inf"))
    out = _layer_norm(_lin(memory.masked_fill(invalid[..., None], 0.0), w, "enc_output", quant),
                      w, "enc_output_norm")
    last = t["decoder_layers"]
    cls_w, cls_b = w[f"cls_branches.{last}.weight"][:1], w[f"cls_branches.{last}.bias"][:1]
    o, cw = (quant(out), quant(cls_w)) if quant is not None else (out, cls_w)
    score = (o.float() @ cw.float().T + cls_b.float())[..., 0]
    top = torch.argsort(score, dim=1, descending=True, stable=True)[:, :cfg["num_queries"]]
    coords = reg_branch(w, last, _gather(out, top), quant).float() + _gather(logits, top)
    ref = coords.sigmoid()
    pe = (coords.sigmoid()[..., None] * (2 * math.pi) / _dim_t(dev))
    pt = _layer_norm(_lin(_sin_cos(pe).flatten(-2).to(dtype), w, "pos_trans", quant), w,
                     "pos_trans_norm")
    qpos, q = pt[..., :t["embed_dims"]], pt[..., t["embed_dims"]:]

    ratios4 = torch.cat([ratios, ratios], -1)[:, None]
    for i in range(t["decoder_layers"]):
        p = f"decoder.{i}"
        q = _layer_norm(q + self_attention(w, f"{p}.self_attn", t["heads"], q + qpos, q, quant),
                        w, f"{p}.norm1")
        q = _layer_norm(q + msda(w, f"{p}.cross_attn", t, q + qpos, memory,
                                 ref[:, :, None] * ratios4, shapes, starts, mask, quant, sample),
                        w, f"{p}.norm2")
        q = _layer_norm(q + ffn(w, f"{p}.ffn", q, quant), w, f"{p}.norm3")
        if refine:
            ref = (reg_branch(w, i, q, quant).float() + inverse_sigmoid(ref)).sigmoid()
    return _lin(q, w, f"cls_branches.{last - 1}", quant).float(), ref, top


# -------------------------------------------------------------------- decode

def to_xyxy(boxes, valid_hw):
    """(N, 4) cxcywh of the valid extent -> xyxy pixels clamped to it."""
    h, w = float(valid_hw[0]), float(valid_hw[1])
    cx, cy, bw, bh = boxes.float().unbind(-1)
    return torch.stack([((cx - 0.5 * bw) * w).clamp(0, w), ((cy - 0.5 * bh) * h).clamp(0, h),
                        ((cx + 0.5 * bw) * w).clamp(0, w), ((cy + 0.5 * bh) * h).clamp(0, h)], -1)


def decode(cls_logits, boxes, valid_hw, cfg, pool=True):
    """One image's (Q, C) logits and (Q, 4) boxes -> (rows, pool):
    rows: the max_per_img (query, class) pairs of highest sigmoid score (a
    stable sort), dict of boxes (K, 4) xyxy, scores (K,), labels (K,);
    pool: every one of the Q x C pairs in the same form (None without)."""
    C = cls_logits.shape[-1]
    s = torch.sigmoid(cls_logits.float()).reshape(-1)
    xyxy = to_xyxy(boxes, valid_hw)
    order = torch.argsort(s, descending=True, stable=True)[:cfg["max_per_img"]]
    rows = dict(boxes=xyxy[order // C], scores=s[order], labels=order % C)
    if not pool:
        return rows, None
    every = torch.arange(s.numel(), device=s.device)
    return rows, dict(boxes=xyxy[every // C], scores=s, labels=every % C)
