# LFD detector (`lfdtpu/models/detector.py`, reference `lfd/model/lfd.py`):
# the net, the point grids, the loss with on-device target assignment, and
# the decode. The loss objects (ops/loss_wrappers.py) decide by class name
# the head's channels, the loss branches and the decode.
#
# Public tensors keep lfdtpu's NHWC layout; inside, the net runs on NCHW
# tensors, in torch.channels_last memory format on the engine path, so the
# NHWC <-> NCHW permutes at the boundary are views, not copies.

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import assign as assign_ops
from ..ops import boxes as box_ops
from ..ops import points as point_ops
from ..ops.decode import DecodeSpec, decode_predictions, detections_to_lists
from ..ops.loss_wrappers import (CLASSIFICATION_LOSSES, INDEPENDENT_REGRESSION_LOSSES,
                                 UNION_REGRESSION_LOSSES)
from ..parallel.distributed import global_sum, global_sums
from .heads import FCOS_PRIOR_BIAS, FCOSHead
from .layers import Scale, kaiming_out_, xavier_uniform_


class DetectionNet(nn.Module):
    """backbone -> neck -> head -> dense (B, P, C) / (B, P, 4) outputs.
    Takes NHWC input; row p of the output is level-major, then (y, x)
    row-major within a level (the order of ops/points.py)."""

    def __init__(self, backbone, neck, head):
        super().__init__()
        self._backbone = backbone
        self._neck = neck
        self._head = head

    def forward(self, x):
        feats = self._backbone(x.permute(0, 3, 1, 2))
        if self._neck is not None:
            feats = self._neck(feats)
        flat = []
        for outs in self._head(feats):
            flat.append(torch.cat(
                [o.permute(0, 2, 3, 1).reshape(o.shape[0], -1, o.shape[1])
                 for o in outs], dim=1))
        return tuple(flat)


def pad_to_multiple(image: np.ndarray, multiple: int):
    """Right/bottom zero-pad an HWC image to a multiple (the reference's batch
    assembly, `data_loader.py:70-85`)."""
    h, w = image.shape[:2]
    ph = (h + multiple - 1) // multiple * multiple
    pw = (w + multiple - 1) // multiple * multiple
    if ph == h and pw == w:
        return image
    out = np.zeros((ph, pw) + image.shape[2:], dtype=image.dtype)
    out[:h, :w] = image
    return out


def _read_image(image):
    if isinstance(image, str):
        import cv2  # only for paths: the GPU machines carry no OpenCV

        path = image
        image = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if image is None:
            raise FileNotFoundError(f"cannot read image {path}")
    image = np.asarray(image)
    if image.ndim == 2:
        image = np.tile(image[..., None], (1, 1, 3))
    return image


def eval_forward(net, images):
    """Dense outputs of `net` in eval mode under inference_mode, on the net's
    own device and dtype; the net is left in the mode it was found in and
    its BN running statistics are not touched.
    images: (B, H, W, 3) array or tensor."""
    p = next(net.parameters())
    was_training = net.training
    net.eval()
    try:
        with torch.inference_mode():
            x = torch.as_tensor(images).to(p.device, non_blocking=True).to(p.dtype)
            return net(x)
    finally:
        net.train(was_training)


def init_net_(net, generator):
    """(Re)initialize every weight of a DetectionNet from `generator` with
    lfdtpu's initializers: kaiming fan-out normal convs (backbone, neck),
    xavier-uniform convs in an FPN neck (`xavier_init`), N(0, 0.01) head
    convs, zero biases but FCOSHead's classification prior, identity norms
    and unit Scales."""
    xavier_neck = getattr(net._neck, "xavier_init", False)
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, nn.Conv2d):
                if name.startswith("_head."):
                    m.weight.normal_(0.0, 0.01, generator=generator)
                elif xavier_neck and name.startswith("_neck."):
                    xavier_uniform_(m.weight, generator)
                else:
                    kaiming_out_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
            elif isinstance(m, Scale):
                m._scale.fill_(1.0)
        for m in net.modules():  # after the loop has zeroed every bias
            if isinstance(m, FCOSHead):
                m._classification.bias.fill_(FCOS_PRIOR_BIAS)


class DenseDetector:
    """What LFD and FCOS share: the net's init, the point grids and the
    reference-API paths over dense outputs. A subclass sets net,
    point_strides, regression_ranges, post_nms_bbox_limit and the level-info
    caches, and defines decode_spec (and, with a third output,
    _score_factors)."""

    gray_ranges = None  # LFD's gray bands ride the level info

    def init(self, generator, device=None):
        """(Re)initialize every weight from `generator` (init_net_). Returns
        the net, in eval mode, on `device` if given."""
        init_net_(self.net, generator)
        if device is not None:
            self.net.to(device)
        return self.net.eval()

    # --------------------------------------------------------- level info
    def level_info(self, input_hw):
        key = (int(input_hw[0]), int(input_hw[1]))
        if key not in self._level_info_cache:
            sizes = point_ops.feature_map_sizes_for_input(key, self.point_strides)
            self._level_info_cache[key] = point_ops.concat_level_info(
                sizes, self.point_strides, self.regression_ranges, self.gray_ranges)
        return self._level_info_cache[key]

    def level_sizes(self, input_hw):
        """Per-level point counts (h*w per level) for an input size."""
        sizes = point_ops.feature_map_sizes_for_input(
            (int(input_hw[0]), int(input_hw[1])), self.point_strides)
        return tuple(h * w for h, w in sizes)

    def level_arrays(self, input_hw, device="cpu"):
        """Per-point constants as tensors on `device`, made once per
        (resolution, device) and reused by every call."""
        key = (int(input_hw[0]), int(input_hw[1]), str(torch.device(device)))
        if key not in self._level_array_cache:
            self._level_array_cache[key] = {
                k: torch.as_tensor(v, device=device)
                for k, v in self.level_info(key[:2]).items()
            }
        return self._level_array_cache[key]

    def num_points(self, input_hw):
        return self.level_info(input_hw)["points"].shape[0]

    # ------------------------------------------------------------ decode
    def _score_factors(self, outputs):
        """(B, P) multiplier of every class score of a point (FCOS's
        centerness), or None."""
        return None

    def decode_batch(self, outputs, input_hw, valid_hw, spec, level_arrays=None):
        """Decode a batch of dense outputs ((B, P, Cc), (B, P, 4), ...);
        valid_hw (B, 2) holds each image's unpadded (h, w) extent inside the
        input."""
        cls_o, reg_o = outputs[:2]
        info = (level_arrays if level_arrays is not None
                else self.level_arrays(input_hw, cls_o.device))
        points, ranges = info["points"], info["ranges"]
        valid_hw = valid_hw.float()
        point_valid = ((points[None, :, 0] < valid_hw[:, 1:2])
                       & (points[None, :, 1] < valid_hw[:, 0:1]))
        level_sizes = self.level_sizes(input_hw) if spec.per_level_limit > 0 else None
        return decode_predictions(cls_o, reg_o, points, ranges, spec, valid_hw,
                                  point_valid=point_valid,
                                  score_factors=self._score_factors(outputs),
                                  level_sizes=level_sizes)

    # ------------------------------------------------- reference-API paths
    def decode_single(self, outputs_single, input_hw, valid_hw, spec,
                      level_arrays=None):
        """Decode one image's dense outputs ((P, Cc), (P, 4), ...: lfdtpu's
        decode_single); valid_hw is its unpadded (h, w)."""
        device = outputs_single[0].device
        if isinstance(valid_hw, torch.Tensor):  # stays on its device: no host data
            vhw = valid_hw.to(device, torch.float32).reshape(1, 2)
        else:
            vhw = torch.as_tensor(valid_hw, dtype=torch.float32, device=device).reshape(1, 2)
        out = self.decode_batch(tuple(o[None] for o in outputs_single), input_hw, vhw, spec,
                                level_arrays)
        return {k: v[0] for k, v in out.items()}

    def results_from_outputs(self, outputs, input_hw, meta_batch, spec=None):
        """Batch of dense outputs -> reference result rows
        (`lfdtpu/models/detector.py:411-443`), shared by get_results and the
        Executor's val loop: one batched decode on the outputs' device, one
        copy of the decoded dict to the host, then per image its rows with
        its own `resize_scale`. Each image's valid extent
        (`resized_height`, `resized_width`) comes from the loader meta."""
        spec = spec or self.decode_spec()
        input_hw = (int(input_hw[0]), int(input_hw[1]))
        B = outputs[0].shape[0]
        metas = [m or {} for m in meta_batch]
        valid_hws = np.asarray(
            [[m.get("resized_height", input_hw[0]), m.get("resized_width", input_hw[1])]
             for m in metas[:B]], np.float32)
        with torch.inference_mode():
            decoded = self.decode_batch(
                tuple(o.float() for o in outputs), input_hw,
                torch.as_tensor(valid_hws).to(outputs[0].device), spec)
        decoded = {k: v.cpu().numpy() for k, v in decoded.items()}
        return [detections_to_lists({k: v[i] for k, v in decoded.items()},
                                    resize_scale=metas[i].get("resize_scale", 1.0))
                for i in range(B)]

    def get_results(self, images, meta_batch, classification_threshold=None,
                    nms_threshold=None):
        """Batched eval decode (`lfd/model/lfd.py:397-430`): images
        (B, H, W, 3), already normalized, through the net on its own device;
        one result list per image."""
        spec = self.decode_spec(classification_threshold, nms_threshold)
        input_hw = (int(images.shape[1]), int(images.shape[2]))
        return self.results_from_outputs(eval_forward(self.net, images), input_hw,
                                         meta_batch, spec)

    def predict_for_single_image(self, image, aug_pipeline=None,
                                 classification_threshold=None,
                                 nms_threshold=None, class_agnostic=False,
                                 size_divisor=None):
        """Single-image prediction (`lfd/model/lfd.py:544-655`) through the
        net on its own device and dtype, the frame zero-padded to a multiple
        of `size_divisor` (default: the largest stride).

        image: path or HWC numpy array (BGR, like the reference's cv2 flow);
        aug_pipeline: optional callable on a {"image": ...} sample.
        Returns [[class_label, score, x1, y1, w, h], ...].
        """
        image = _read_image(image)
        if aug_pipeline is not None:
            image = _read_image(aug_pipeline({"image": image})["image"])
        image = image.astype(np.float32)
        h, w = image.shape[:2]
        padded = pad_to_multiple(image, size_divisor or max(self.point_strides))
        input_hw = tuple(int(v) for v in padded.shape[:2])
        spec = self.decode_spec(classification_threshold, nms_threshold,
                                class_agnostic=class_agnostic)
        # eval mode, as lfdtpu's train=False: a net left in train() would
        # predict with batch statistics and write into its running stats
        outs = eval_forward(self.net, padded[None])
        with torch.inference_mode():
            decoded = self.decode_single(tuple(o[0] for o in outs), input_hw, (h, w), spec)
        return detections_to_lists(decoded)


class LFD(DenseDetector):
    """Anchor-free multi-scale detector with soft center-score targets: owns
    the net (an nn.Module holding the weights), the point grids, the loss
    and the decode."""

    ASSIGN_MODES = ("longer", "shorter", "sqrt", "dist")
    detector_name = "LFD"

    def __init__(
        self,
        backbone=None,
        neck=None,
        head=None,
        num_classes=80,
        regression_ranges=((0, 64), (64, 128), (128, 256), (256, 512), (512, 1024)),
        gray_range_factors=(0.9, 1.1),
        range_assign_mode="dist",
        point_strides=(8, 16, 32, 64, 128),
        classification_loss_func=None,
        regression_loss_func=None,
        distance_to_bbox_mode="exp",
        enable_classification_weight=False,
        enable_regression_weight=False,
        classification_threshold=0.05,
        nms_threshold=0.4,
        pre_nms_bbox_limit=1000,
        post_nms_bbox_limit=100,
    ):
        assert len(regression_ranges) == len(point_strides)
        assert range_assign_mode in self.ASSIGN_MODES
        assert distance_to_bbox_mode in ("exp", "sigmoid")
        cls_name = type(classification_loss_func).__name__
        reg_name = type(regression_loss_func).__name__
        assert cls_name in CLASSIFICATION_LOSSES, cls_name
        assert reg_name in INDEPENDENT_REGRESSION_LOSSES + UNION_REGRESSION_LOSSES, reg_name
        self.net = DetectionNet(backbone, neck, head)
        self.num_classes = num_classes
        self.regression_ranges = tuple(tuple(r) for r in regression_ranges)
        self.gray_range_factors = (min(gray_range_factors), max(gray_range_factors))
        self.gray_ranges = point_ops.compute_gray_ranges(
            self.regression_ranges, self.gray_range_factors)
        self.range_assign_mode = range_assign_mode
        self.point_strides = tuple(int(s) for s in point_strides)
        self.classification_loss_func = classification_loss_func
        self.regression_loss_func = regression_loss_func
        self.classification_loss_type = cls_name
        self.regression_loss_type = (
            "independent" if reg_name in INDEPENDENT_REGRESSION_LOSSES else "union")
        self.distance_to_bbox_mode = distance_to_bbox_mode
        self.enable_classification_weight = enable_classification_weight
        self.enable_regression_weight = enable_regression_weight
        self.classification_threshold = classification_threshold
        self.nms_threshold = nms_threshold
        self.pre_nms_bbox_limit = pre_nms_bbox_limit
        self.post_nms_bbox_limit = post_nms_bbox_limit
        self._level_info_cache = {}
        self._level_array_cache = {}

    # ----------------------------------------------------------------- net
    @property
    def cls_channels(self):
        return (self.num_classes + 1
                if self.classification_loss_type == "CrossEntropyLoss"
                else self.num_classes)

    # -------------------------------------------------------------- loss
    def _assign(self, info, gt_bboxes, gt_labels, gt_mask):
        """Batched target assignment (lfdtpu's `_assign_single`, vmapped
        there), the seam a detector variant overrides."""
        return assign_ops.lfd_assign(
            info["points"], info["strides"], info["ranges"], info["gray_ranges"],
            gt_bboxes, gt_labels, gt_mask, self.num_classes,
            range_assign_mode=self.range_assign_mode,
            normalize_by_range=self.regression_loss_type == "independent")

    def get_loss(self, outputs, gt_bboxes, gt_labels, gt_mask, input_hw,
                 level_arrays=None, mesh=None):
        """Loss with on-device target assignment (`lfdtpu` get_loss,
        `lfd/model/lfd.py:284-395` semantics), in the outputs' dtype (float32
        from the train step; float64 works too), with no host sync.

        Args:
          outputs: (cls (B, P, Cc), reg (B, P, 4)).
          gt_bboxes: (B, Nmax, 4) float xywh, zero-padded.
          gt_labels: (B, Nmax) int.
          gt_mask: (B, Nmax) bool.
          input_hw: (h, w) of the network input.
          level_arrays: the per-point constants on the outputs' device
            (default: level_arrays(input_hw, device), cached).
          mesh: a parallel.Mesh whose ranks hold the other rows of the
            global batch: the normalizers (num_pos, the weight sums) are
            global sums, clamped after the sum, so that the ranks' losses
            add up to lfdtpu's loss of the global batch.
        Returns {"loss": 0-d tensor (this rank's share), "loss_values":
          {loss, classification_loss, regression_loss, num_pos}, global}.
        """
        cls_pred, reg_pred = outputs
        B, P = cls_pred.shape[:2]
        info = (level_arrays if level_arrays is not None
                else self.level_arrays(input_hw, cls_pred.device))
        assert info["points"].shape[0] == P, (info["points"].shape, P)

        cls_t, reg_t = self._assign(info, gt_bboxes.to(info["points"].dtype), gt_labels,
                                    gt_mask.bool())

        cls_pred_f = cls_pred.reshape(-1, self.cls_channels)
        reg_pred_f = reg_pred.reshape(-1, 4)
        cls_t_f = cls_t.reshape(-1, self.num_classes)
        reg_t_f = reg_t.reshape(-1, 4)

        # gray rows dropped; positives = max score >= 0.001 (`lfd.py:314-323`)
        valid_row = (cls_t_f.amin(dim=-1) >= 0).to(cls_pred.dtype)
        max_scores, max_idx = cls_t_f.max(dim=-1)
        pos_row = valid_row * (max_scores >= 0.001).to(cls_pred.dtype)
        num_pos = global_sum(pos_row.sum(), mesh)
        weight = max_scores * pos_row
        weight_sum = (global_sum(weight.sum(), mesh) if self.enable_classification_weight
                      or self.enable_regression_weight else None)
        cls_avg = weight_sum if self.enable_classification_weight else num_pos + 1.0

        cname = self.classification_loss_type
        if cname == "BCEWithLogitsLoss":  # soft score targets
            cls_loss = self.classification_loss_func(
                cls_pred_f, cls_t_f.clamp(min=0.0), weight=valid_row[:, None],
                avg_factor=cls_avg)
        else:
            labels = torch.where(pos_row > 0, max_idx,
                                 torch.full_like(max_idx, self.num_classes))
            # QFL takes (label, score); Focal and CE (over C+1) the labels
            target = (labels, max_scores) if cname == "QualityFocalLoss" else labels
            cls_loss = self.classification_loss_func(
                cls_pred_f, target, weight=valid_row, avg_factor=cls_avg)

        reg_weight_rows = weight if self.enable_regression_weight else pos_row
        reg_avg = (weight_sum if self.enable_regression_weight else num_pos).clamp(min=1e-6)

        if self.regression_loss_type == "independent":
            reg_loss = self.regression_loss_func(
                reg_pred_f, reg_t_f, weight=reg_weight_rows[:, None], avg_factor=reg_avg)
        else:
            pts_f = info["points"].repeat(B, 1)
            target_xyxy = box_ops.distance2bbox(pts_f, reg_t_f)
            if self.distance_to_bbox_mode == "exp":
                # clamped: unsupervised (zero-weight) rows can drift to exp
                # overflow, and inf areas make the IoU losses' union
                # inf-inf=NaN, which weight*loss (NaN*0) cannot mask
                dist = torch.exp(reg_pred_f.clamp(max=30.0))
            else:
                rmax = info["ranges"].amax(dim=-1, keepdim=True).repeat(B, 1)
                dist = torch.sigmoid(reg_pred_f) * rmax
            pred_xyxy = box_ops.distance2bbox(pts_f, dist)
            reg_loss = self.regression_loss_func(
                pred_xyxy, target_xyxy, weight=reg_weight_rows, avg_factor=reg_avg)

        loss = cls_loss + reg_loss
        values = global_sums(dict(loss=loss, classification_loss=cls_loss,
                                  regression_loss=reg_loss), mesh)
        return dict(loss=loss, loss_values=dict(values, num_pos=num_pos))

    # ------------------------------------------------------------ decode
    def decode_spec(self, classification_threshold=None, nms_threshold=None,
                    class_agnostic=False, max_det=None):
        if self.regression_loss_type == "independent":
            reg_mode = "independent"
        else:
            reg_mode = self.distance_to_bbox_mode
        return DecodeSpec(
            num_classes=self.num_classes,
            use_softmax=self.classification_loss_type == "CrossEntropyLoss",
            reg_mode=reg_mode,
            score_thr=float(self.classification_threshold
                            if classification_threshold is None
                            else classification_threshold),
            nms_iou=float(self.nms_threshold if nms_threshold is None
                          else nms_threshold),
            pre_nms_points=self.pre_nms_bbox_limit,
            nms_budget=self.pre_nms_bbox_limit,
            max_det=self.post_nms_bbox_limit if max_det is None else max_det,
            class_agnostic=class_agnostic,
        )

    def predict_for_single_image_with_engine(self, engine, image, aug_pipeline=None):
        """Predict through a compiled deployment engine (the analogue of the
        reference's `predict_for_single_image_with_tensorrt`): the image is
        zero-padded into the engine's input resolution."""
        return self.predict_for_batch_with_engine(engine, [image], aug_pipeline)[0]

    def predict_for_batch_with_engine(self, engine, images, aug_pipeline=None):
        """Batched engine predict: each image is zero-padded into the
        engine's bucket and its own valid extent rides the (B, 2) valid_hw.
        The batch must match the engine's batch_size.
        Returns one [[class_label, score, x1, y1, w, h], ...] per image."""
        eh, ew = engine.input_resolution
        processed = []
        for image in images:
            image = _read_image(image)
            if aug_pipeline is not None:
                image = _read_image(aug_pipeline({"image": image})["image"])
            h, w = image.shape[:2]
            if h > eh or w > ew:
                raise ValueError(f"image {h}x{w} exceeds engine resolution {eh}x{ew}")
            processed.append(image)
        batch = np.zeros((len(processed), eh, ew, 3), processed[0].dtype)
        hws = np.zeros((len(processed), 2), np.float32)
        for i, image in enumerate(processed):
            h, w = image.shape[:2]
            batch[i, :h, :w] = image
            hws[i] = (h, w)
        decoded = engine(batch, hws)
        decoded = {k: v.cpu().numpy() for k, v in decoded.items()}
        return [detections_to_lists({k: v[i] for k, v in decoded.items()})
                for i in range(len(processed))]
