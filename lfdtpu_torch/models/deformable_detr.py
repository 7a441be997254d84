# Deformable DETR, two-stage with iterative box refinement (Zhu et al.,
# "Deformable DETR: Deformable Transformers for End-to-End Object
# Detection", ICLR 2021), as mmdetection v2.28.2 and mmcv 1.x define it
# (`configs/deformable_detr/deformable_detr_twostage_refine_r50_16x2_50e_coco.py`):
#
#   backbone   ResNet-50, pytorch style, stage 1 frozen, norm_eval; C3-C5
#   neck       ChannelMapper to 256: a 1x1 conv + GN32 a level, a 3x3/s2
#              conv + GN32 on the raw C5 as the 4th level, no activation
#   positions  sine (128 features an axis, normalized, offset -0.5, 2 pi,
#              temperature 10000, eps 1e-6) over the padding mask, y half
#              first, plus a learned embedding a level
#   encoder    6 x [MSDA self-attention from the token centres, LayerNorm,
#              FFN 256 -> 1024 -> 256, LayerNorm]
#   two-stage  a proposal a token ((x + 0.5) / W_valid, (y + 0.5) / H_valid,
#              0.05 * 2^level), inf where invalid or padded; memory zeroed
#              there, LayerNorm(Linear); the top 300 tokens by class 0 of
#              cls_branches[6]; their boxes reg_branches[6] + proposals; the
#              query and its position from LayerNorm(Linear 512 -> 512) of
#              the boxes' sine embedding
#   decoder    6 x [self-attention over the 300 queries (q = k = query +
#              pos, v = query), LayerNorm, MSDA cross-attention from 4-d
#              reference boxes, LayerNorm, FFN, LayerNorm], each followed by
#              ref = sigmoid(reg_branches[i](out) + inverse_sigmoid(ref))
#   decode     the top 100 of the last layer's 300 x 80 sigmoid scores,
#              cxcywh -> xyxy scaled by the valid extent and clamped to it;
#              no threshold and no NMS
# MSDA: 256 wide, 8 heads, 4 levels, 4 points; the value zeroed at padded
# tokens; offsets by Linear(256, 256), weights by Linear(256, 128) and a
# softmax over a head's 16 (level, point) pairs; a location is ref + off /
# (W_l, H_l) from a 2-d reference, ref_xy + off / 4 * ref_wh * 0.5 from a 4-d
# one; the samples go through ops/msda.py::ms_deform_attn.
#
# The net takes the frames and their valid extents (B, 2): the padding mask,
# the valid ratios, the references and the proposals are made on the device
# from them, so a captured engine masks a smaller frame as mmdetection does.
# In a bf16 engine these stay float32: the sampling locations, the reference
# boxes and inverse_sigmoid, the attention weights' softmax, the positions'
# sine embeddings and the decode's scores.
#
# Departures from mmdetection, each with its reason:
#   - dropout is left out: the port serves (mmdet's is inactive in eval);
#   - the two-stage selection scores the tokens by class 0 alone, in float32
#     (mmdet computes all 80 classes and uses the first): the other 79 are
#     never read, and a bf16 logit would tie at the 300th place;
#   - reg_branches[6] runs on the 300 selected tokens only, after the
#     selection (mmdet runs it on every token and then gathers): the same
#     rows, a row at a time;
#   - the decoder's self-attention is F.scaled_dot_product_attention over
#     an in_proj of (768, 256) named `in_proj` (nn.MultiheadAttention's
#     in_proj_weight / in_proj_bias are the same numbers).

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops import msda
from ..ops.decode import DecodeSpec
from .detector import EngineDetector

POS_FEATS = 128          # sine features an axis
TEMPERATURE = 10000.0
POS_OFFSET = -0.5
POS_EPS = 1e-6
PROPOSAL_SIZE = 0.05     # a level-0 proposal's width and height, doubled a level
PROPOSAL_LIMITS = (0.01, 0.99)
INVERSE_SIGMOID_EPS = 1e-5


def inverse_sigmoid(x, eps=INVERSE_SIGMOID_EPS):
    """mmdet's inverse_sigmoid: log(x / (1 - x)), both clamped to eps."""
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def _dim_t(device):
    t = torch.arange(POS_FEATS, dtype=torch.float32, device=device)
    return TEMPERATURE ** (2 * (t // 2) / POS_FEATS)


def _interleave(pos):
    """(..., 128) angles -> sin of the even ones and cos of the odd ones,
    interleaved."""
    return torch.stack((pos[..., 0::2].sin(), pos[..., 1::2].cos()), dim=-1).flatten(-2)


def sine_positions(mask):
    """mmdet's SinePositionalEncoding(128, normalize=True, offset=-0.5) of a
    (B, h, w) padding mask (True where padded) as (B, h * w, 256) float32
    tokens, the y half first."""
    not_mask = (~mask).float()
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    y = (y + POS_OFFSET) / (y[:, -1:, :] + POS_EPS) * (2 * math.pi)
    x = (x + POS_OFFSET) / (x[:, :, -1:] + POS_EPS) * (2 * math.pi)
    dim_t = _dim_t(mask.device)
    pos = torch.cat((_interleave(y[..., None] / dim_t), _interleave(x[..., None] / dim_t)), -1)
    return pos.flatten(1, 2)


def proposal_positions(coords_unact):
    """mmdet's get_proposal_pos_embed: (B, Q, 4) box logits -> (B, Q, 512)
    float32, 128 sine features a coordinate of sigmoid(box) * 2 pi."""
    pos = coords_unact.sigmoid()[..., None] * (2 * math.pi) / _dim_t(coords_unact.device)
    return _interleave(pos).flatten(-2)


def level_masks(valid_hw, input_hw, shapes):
    """Per level a (B, h, w) bool mask, True where padded: the frame's mask
    at input_hw (a pixel is padded outside its image's valid extent)
    nearest-downsampled to the level, as mmdet's F.interpolate does."""
    dev = valid_hw.device
    vh, vw = valid_hw[:, 0, None, None], valid_hw[:, 1, None, None]
    rows = torch.arange(input_hw[0], dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(input_hw[1], dtype=torch.float32, device=dev)[None, None, :]
    image = ((rows >= vh) | (cols >= vw)).float()
    return [F.interpolate(image[None], size=s)[0].bool() for s in shapes]


class MSDeformAttn(nn.Module):
    """mmcv's MultiScaleDeformableAttention, without its residual (the
    layers add it): forward(query, value, reference, ...) -> output_proj of
    the weighted samples."""

    def __init__(self, dim=256, heads=8, levels=4, points=4):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query, value, reference, shapes, starts, value_mask, wh):
        """query (B, Q, dim) with its position added; value (B, S, dim);
        reference (B, Q, levels, 2 or 4) float32; value_mask (B, S) True
        where padded; wh (levels, 2) float32 [w, h] of each level."""
        B, Q, _ = query.shape
        nh, L, P = self.heads, self.levels, self.points
        v = self.value_proj(value).masked_fill(value_mask[..., None], 0.0)
        v = v.view(B, v.shape[1], nh, -1)
        off = self.sampling_offsets(query).view(B, Q, nh, L, P, 2).float()
        weights = self.attention_weights(query).view(B, Q, nh, L * P).float().softmax(-1)
        ref = reference[:, :, None, :, None]
        if reference.shape[-1] == 2:
            loc = ref + off / wh[None, None, None, :, None, :]
        else:
            loc = ref[..., :2] + off / P * ref[..., 2:] * 0.5
        out = msda.ms_deform_attn(v, shapes, starts, loc, weights.view(B, Q, nh, L, P))
        return self.output_proj(out)


class FFN(nn.Module):
    """Linear -> ReLU -> Linear, without its residual."""

    def __init__(self, dim=256, hidden=1024):
        super().__init__()
        self.layers = nn.Sequential(nn.Linear(dim, hidden), nn.ReLU(), nn.Linear(hidden, dim))

    def forward(self, x):
        return self.layers(x)


class EncoderLayer(nn.Module):
    def __init__(self, dim=256, hidden=1024, **msda_kw):
        super().__init__()
        self.attn = MSDeformAttn(dim, **msda_kw)
        self.norm1 = nn.LayerNorm(dim)
        self.ffn = FFN(dim, hidden)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, x, pos, reference, shapes, starts, mask, wh):
        x = self.norm1(x + self.attn(x + pos, x, reference, shapes, starts, mask, wh))
        return self.norm2(x + self.ffn(x))


class SelfAttention(nn.Module):
    """nn.MultiheadAttention's math over batch-first tokens: q and k from
    `qk`, v from `v`, softmax(q k^T / sqrt(d)) v a head, then out_proj."""

    def __init__(self, dim=256, heads=8):
        super().__init__()
        self.heads = heads
        self.in_proj = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, qk, v):
        B, Q, C = v.shape
        w, b = self.in_proj.weight, self.in_proj.bias
        q, k = F.linear(qk, w[:2 * C], b[:2 * C]).chunk(2, dim=-1)
        v = F.linear(v, w[2 * C:], b[2 * C:])
        q, k, v = (t.view(B, Q, self.heads, -1).transpose(1, 2) for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(B, Q, C))


class DecoderLayer(nn.Module):
    def __init__(self, dim=256, hidden=1024, heads=8, **msda_kw):
        super().__init__()
        self.self_attn = SelfAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn = MSDeformAttn(dim, heads=heads, **msda_kw)
        self.norm2 = nn.LayerNorm(dim)
        self.ffn = FFN(dim, hidden)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, q, pos, memory, reference, shapes, starts, mask, wh):
        q = self.norm1(q + self.self_attn(q + pos, q))
        q = self.norm2(q + self.cross_attn(q + pos, memory, reference, shapes, starts, mask, wh))
        return self.norm3(q + self.ffn(q))


def _reg_branch(dim):
    return nn.Sequential(nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, dim), nn.ReLU(),
                         nn.Linear(dim, 4))


def _gather(x, idx):
    """x (B, N, D), idx (B, M) -> (B, M, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class DeformableDETRNet(nn.Module):
    """forward(frames (B, H, W, 3) NHWC, valid_hw (B, 2)) -> (class logits
    (B, 300, 80), boxes (B, 300, 4) cxcywh in [0, 1] of the valid extent),
    both float32: the last decoder layer's. Under a profiler session an
    eager call records the stream spans `detr.encoder`, `detr.select` and
    `detr.decoder` (tracing.py)."""

    def __init__(self, backbone, neck, num_classes=80, dim=256, heads=8, levels=4, points=4,
                 hidden=1024, encoder_layers=6, decoder_layers=6, num_queries=300):
        super().__init__()
        self._backbone = backbone
        self._neck = neck
        self.num_queries = num_queries
        msda_kw = dict(levels=levels, points=points)
        self.level_embeds = nn.Parameter(torch.zeros(levels, dim))
        self.encoder = nn.ModuleList(EncoderLayer(dim, hidden, heads=heads, **msda_kw)
                                     for _ in range(encoder_layers))
        self.enc_output = nn.Linear(dim, dim)
        self.enc_output_norm = nn.LayerNorm(dim)
        self.pos_trans = nn.Linear(2 * dim, 2 * dim)
        self.pos_trans_norm = nn.LayerNorm(2 * dim)
        self.decoder = nn.ModuleList(DecoderLayer(dim, hidden, heads, **msda_kw)
                                     for _ in range(decoder_layers))
        # one more of each than decoder layers: the last scores the proposals
        self.cls_branches = nn.ModuleList(nn.Linear(dim, num_classes)
                                          for _ in range(decoder_layers + 1))
        self.reg_branches = nn.ModuleList(_reg_branch(dim) for _ in range(decoder_layers + 1))

    # ------------------------------------------------------------ inputs
    def _tokens(self, x, valid_hw):
        """The neck's levels as tokens, with everything the layers read."""
        feats = self._neck(self._backbone(x.permute(0, 3, 1, 2)))
        B, dev = x.shape[0], x.device
        shapes = [tuple(int(v) for v in f.shape[-2:]) for f in feats]
        starts = [sum(h * w for h, w in shapes[:i]) for i in range(len(shapes))]
        masks = level_masks(valid_hw.float(), x.shape[1:3], shapes)
        src = torch.cat([f.permute(0, 2, 3, 1).reshape(B, -1, f.shape[1]) for f in feats], 1)
        pos = torch.cat([sine_positions(m) + e.float() for m, e in zip(masks, self.level_embeds)],
                        1).to(src.dtype)
        mask = torch.cat([m.flatten(1) for m in masks], 1)
        valid_h = torch.stack([(~m[:, :, 0]).sum(1) for m in masks], 1).float()  # (B, L)
        valid_w = torch.stack([(~m[:, 0, :]).sum(1) for m in masks], 1).float()
        # the levels' sizes made on the device: a capture copies nothing in
        hs = torch.stack([torch.full((), float(h), device=dev) for h, _ in shapes])
        ws = torch.stack([torch.full((), float(w), device=dev) for _, w in shapes])
        ratios = torch.stack([valid_w / ws, valid_h / hs], -1)  # (B, L, 2) [w, h]
        return dict(src=src, pos=pos, mask=mask, shapes=shapes, starts=starts, ratios=ratios,
                    valid_h=valid_h, valid_w=valid_w, wh=torch.stack([ws, hs], -1))

    def _centres(self, t):
        """The encoder's references: each token's centre over its level's
        valid extent, times every level's valid ratio: (B, S, L, 2)."""
        refs = []
        dev, ratios = t["src"].device, t["ratios"]
        for lvl, (h, w) in enumerate(t["shapes"]):
            ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
            xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
            ry = ys[None, :, None] / (ratios[:, None, None, lvl, 1] * h)
            rx = xs[None, None, :] / (ratios[:, None, None, lvl, 0] * w)
            refs.append(torch.stack(torch.broadcast_tensors(rx, ry), -1).flatten(1, 2))
        return torch.cat(refs, 1)[:, :, None] * ratios[:, None]

    def _proposals(self, t):
        """(B, S, 4) box logits of the tokens' proposals (inf where a
        proposal leaves (0.01, 0.99) or its token is padded) and (B, S) True
        where so."""
        dev = t["src"].device
        props = []
        for lvl, (h, w) in enumerate(t["shapes"]):
            ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
            xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
            cy = ys[None, :, None] / t["valid_h"][:, lvl, None, None]
            cx = xs[None, None, :] / t["valid_w"][:, lvl, None, None]
            cx, cy = torch.broadcast_tensors(cx, cy)
            size = torch.full_like(cx, PROPOSAL_SIZE * 2.0 ** lvl)
            props.append(torch.stack([cx, cy, size, size], -1).flatten(1, 2))
        p = torch.cat(props, 1)
        lo, hi = PROPOSAL_LIMITS
        invalid = ~((p > lo) & (p < hi)).all(-1) | t["mask"]
        return torch.log(p / (1 - p)).masked_fill(invalid[..., None], float("inf")), invalid

    # ----------------------------------------------------------- forward
    def _refine(self, i, q, ref):
        """Decoder layer i's box refinement: sigmoid(reg_branches[i](q) +
        inverse_sigmoid(ref)), float32."""
        return (self.reg_branches[i](q).float() + inverse_sigmoid(ref)).sigmoid()

    def _select(self, memory, t):
        """The two-stage selection: the num_queries tokens of highest
        class-0 logit (B, Q) and their boxes' logits (B, Q, 4) float32."""
        logits, invalid = self._proposals(t)
        out = self.enc_output_norm(self.enc_output(memory.masked_fill(invalid[..., None], 0.0)))
        cls = self.cls_branches[-1]
        score = F.linear(out.float(), cls.weight[:1].float(), cls.bias[:1].float())[..., 0]
        top = score.topk(self.num_queries, dim=1).indices
        return top, self.reg_branches[-1](_gather(out, top)).float() + _gather(logits, top)

    def forward(self, x, valid_hw):
        t = self._tokens(x, valid_hw)
        args = (t["shapes"], t["starts"], t["mask"], t["wh"])
        with tracing.span("detr.encoder", x.device):
            memory, centres = t["src"], self._centres(t)
            for layer in self.encoder:
                memory = layer(memory, t["pos"], centres, *args)
        with tracing.span("detr.select", x.device):
            _, coords = self._select(memory, t)
            ref = coords.sigmoid()
            pos, q = self.pos_trans_norm(self.pos_trans(
                proposal_positions(coords).to(memory.dtype))).chunk(2, dim=-1)
        with tracing.span("detr.decoder", x.device):
            ratios4 = torch.cat([t["ratios"], t["ratios"]], -1)[:, None]
            for i, layer in enumerate(self.decoder):
                q = layer(q, pos, memory, ref[:, :, None] * ratios4, *args)
                ref = self._refine(i, q, ref)
            return self.cls_branches[len(self.decoder) - 1](q).float(), ref


def boxes_to_frame(boxes, valid_hw):
    """(B, N, 4) cxcywh in [0, 1] of the valid extent -> xyxy pixels
    clamped to it (mmdet's bbox_cxcywh_to_xyxy, scale and clamp)."""
    cx, cy, w, h = boxes.unbind(-1)
    vh, vw = valid_hw[:, 0, None], valid_hw[:, 1, None]
    return torch.stack([((cx - 0.5 * w) * vw).clamp(min=0).minimum(vw),
                        ((cy - 0.5 * h) * vh).clamp(min=0).minimum(vh),
                        ((cx + 0.5 * w) * vw).clamp(min=0).minimum(vw),
                        ((cy + 0.5 * h) * vh).clamp(min=0).minimum(vh)], -1)


class DeformableDETR(EngineDetector):
    """The detector the engine serves: the net (DeformableDETRNet) and its
    set-prediction decode. No point grid, no threshold, no NMS: every frame
    yields exactly max_det rows."""

    detector_name = "DeformableDETR"
    query_set = True

    def __init__(self, net, num_classes=80, max_per_img=100):
        self.net = net
        self.num_classes = num_classes
        self.max_per_img = max_per_img

    def decode_spec(self, classification_threshold=None, nms_threshold=None,
                    class_agnostic=False, max_det=None):
        """The decode's one setting, max_det, in a DecodeSpec (no threshold
        and no NMS: asking for either raises)."""
        if classification_threshold is not None or nms_threshold is not None or class_agnostic:
            raise ValueError("Deformable DETR's decode has no threshold and no NMS")
        return DecodeSpec(num_classes=self.num_classes, score_thr=0.0, nms_iou=1.0,
                          max_det=self.max_per_img if max_det is None else max_det)

    def level_arrays(self, input_hw, device="cpu"):
        """None: the queries carry their own boxes."""
        return {}

    def decode_batch(self, outputs, input_hw, valid_hw, spec, level_arrays=None):
        """(class logits (B, Q, C), boxes (B, Q, 4)) -> the top max_det of
        the Q x C sigmoid scores (label idx % C, query idx // C), their
        boxes in pixels of each image's valid extent: boxes (B, K, 4) xyxy,
        scores (B, K), labels (B, K) int32, count (B,) int32 = K."""
        cls, boxes = outputs[0].float(), outputs[1].float()
        B, _, C = cls.shape
        scores, idx = cls.sigmoid().flatten(1).topk(spec.max_det, dim=1)
        xyxy = boxes_to_frame(_gather(boxes, idx // C), valid_hw.float())
        return dict(boxes=xyxy, scores=scores, labels=(idx % C).int(),
                    count=torch.full((B,), spec.max_det, dtype=torch.int32,
                                     device=cls.device))
