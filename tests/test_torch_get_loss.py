# LFD.get_loss of the port against lfdtpu's on the CPU: the same seeded dense
# outputs and padded GT through both, for WIDERFACE-S (focal + IoU, 'dist'),
# TT100K-S (45-class softmax CE + IoU, 'longer') and TL-S (QFL x2 + IoU),
# and the branches no zoo config takes.
# All four loss_values within rtol 1e-5 and the gradients into the dense
# outputs within max|err|/max|ref| 1e-5 (sums over rows in another order).
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu.ops import loss_wrappers as JW
from lfdtpu_torch.ops import loss_wrappers as TW
from tests.test_torch_bridge import jax_and_port
from tests.test_torch_train_step import HW, make_batch, max_rel

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["WIDERFACE-S", "TT100K-S", "TL-S"])
def test_get_loss_matches_lfdtpu(name):
    jdet, _, tdet = jax_and_port(name)
    check_get_loss(jdet, tdet, seed=len(name))


def check_get_loss(jdet, tdet, seed):
    P = jdet.num_points(HW)
    rng = np.random.RandomState(seed)
    cls_o = rng.normal(0.0, 2.0, (2, P, jdet.cls_channels)).astype(np.float32)
    reg_o = rng.normal(0.0, 1.0, (2, P, 4)).astype(np.float32)
    _, gt, labels, mask = make_batch(3, num_classes=jdet.num_classes)

    def jax_loss(c, r):
        ld = jdet.get_loss((c, r), jnp.asarray(gt), jnp.asarray(labels),
                           jnp.asarray(mask), HW)
        return ld["loss"], ld["loss_values"]

    (_, jvals), (jgc, jgr) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(cls_o), jnp.asarray(reg_o))
    tc = torch.from_numpy(cls_o).requires_grad_()
    tr = torch.from_numpy(reg_o).requires_grad_()
    ld = tdet.get_loss((tc, tr), torch.from_numpy(gt), torch.from_numpy(labels),
                       torch.from_numpy(mask), HW)
    ld["loss"].backward()
    assert set(ld["loss_values"]) == set(jvals)
    assert float(jvals["num_pos"]) > 0
    for k, v in ld["loss_values"].items():
        np.testing.assert_allclose(float(v.detach()), float(jvals[k]), rtol=1e-5, err_msg=k)
    # gradients into the dense outputs: summed over rows in another order
    assert max_rel(tc.grad.numpy(), jgc) < 1e-5
    assert max_rel(tr.grad.numpy(), jgr) < 1e-5


def with_losses(det, wrappers, cls_name, reg_name, mode, weighted):
    """A shallow copy of `det` with other configured losses, decode mode and
    loss weighting (the attributes LFD.__init__ derives, in both packages)."""
    det = copy.copy(det)
    det.classification_loss_func = getattr(wrappers, cls_name)()
    det.regression_loss_func = getattr(wrappers, reg_name)()
    det.classification_loss_type = cls_name
    det.regression_loss_type = ("independent" if reg_name in
                                wrappers.INDEPENDENT_REGRESSION_LOSSES else "union")
    det.distance_to_bbox_mode = mode
    det.enable_classification_weight = det.enable_regression_weight = weighted
    return det


@pytest.mark.parametrize("cls_name,reg_name,mode,weighted", [
    ("BCEWithLogitsLoss", "GIoULoss", "exp", False),
    ("FocalLoss", "SmoothL1Loss", "sigmoid", True),
    ("QualityFocalLoss", "CIoULoss", "exp", True),
])
def test_get_loss_branches_match_lfdtpu(cls_name, reg_name, mode, weighted):
    # the branches no zoo config takes: soft-target BCE, independent
    # regression (targets divided by the range), exp decode, weighting
    jdet, _, tdet = jax_and_port("WIDERFACE-S")
    jdet = with_losses(jdet, JW, cls_name, reg_name, mode, weighted)
    tdet = with_losses(tdet, TW, cls_name, reg_name, mode, weighted)
    check_get_loss(jdet, tdet, seed=len(cls_name) + len(reg_name))
