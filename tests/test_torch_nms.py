# K1 (greedy-NMS keep mask): the port's plain version and its nms_mask /
# batched_nms callers against lfdtpu's lax fixpoint and its Pallas kernel in
# interpret mode. Masks must be EXACT, including tied scores (lfdtpu orders
# ties by reversing a stable ascending argsort: higher index first) and
# `valid` holes. The CUDA kernel against the plain version runs on the card.
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lfdtpu.ops.nms  # noqa: F401  (the package attribute `nms` is a function)
from lfdtpu.ops.nms_pallas import nms_mask_pallas_sorted
from lfdtpu_torch.ops import nms_kernel
from lfdtpu_torch.ops.nms import batched_nms, nms_mask

torch.set_num_threads(1)
JN = sys.modules["lfdtpu.ops.nms"]


def random_boxes(rng, B, K, span=100.0, size=40.0):
    xy = rng.rand(B, K, 2) * span
    wh = rng.rand(B, K, 2) * size + 1
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def jax_mask(boxes, scores, thr, valid):
    return np.stack([
        np.asarray(JN.nms_mask(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), thr,
                               valid=jnp.asarray(valid[b]), use_pallas=False))
        for b in range(boxes.shape[0])])


def port_mask(boxes, scores, thr, valid):
    return nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                    valid=torch.from_numpy(valid)).numpy()


@pytest.mark.parametrize("K", [64, 200, 1000])
def test_plain_matches_lax_fixpoint(K):
    rng = np.random.RandomState(K)
    boxes = random_boxes(rng, 2, K, span=10 * K ** 0.5)
    scores = rng.rand(2, K).astype(np.float32)
    valid = rng.rand(2, K) > 0.2
    for thr in (0.3, 0.5):
        np.testing.assert_array_equal(port_mask(boxes, scores, thr, valid),
                                      jax_mask(boxes, scores, thr, valid))


def test_plain_matches_pallas_interpret():
    rng = np.random.RandomState(1)
    K = 128
    boxes = random_boxes(rng, 3, K)
    valid = rng.rand(3, K) > 0.2
    got = nms_kernel.nms_mask_sorted_plain(torch.from_numpy(boxes),
                                           torch.from_numpy(valid), 0.5).numpy()
    for b in range(3):
        ref = np.asarray(nms_mask_pallas_sorted(jnp.asarray(boxes[b]),
                                                jnp.asarray(valid[b]), 0.5,
                                                interpret=True))
        np.testing.assert_array_equal(got[b], ref)


@pytest.mark.parametrize("K", [200, 130])
@pytest.mark.parametrize("case", ["chain", "all kept", "all suppressed"])
def test_long_suppression_chain_matches(case, K):
    """The walk's hard cases (`nms_kernel.walk_cases`), above all the chain:
    greedy keeps every other box and the fixpoint needs about K sweeps. K =
    130 is not a multiple of the kernel's 64-box chunks. Image 1 has valid
    holes."""
    rng = np.random.RandomState(K)
    boxes, valid = (a.numpy() for a in nms_kernel.walk_cases(2, K)[case])
    valid[1] = rng.rand(K) > 0.1
    scores = np.tile((K - np.arange(K, dtype=np.float32)) / K, (2, 1))  # sorted already
    got = port_mask(boxes, scores, 0.4, valid)
    np.testing.assert_array_equal(got, jax_mask(boxes, scores, 0.4, valid))
    want = {"chain": np.arange(K) % 2 == 0, "all kept": np.ones(K, bool),
            "all suppressed": np.arange(K) == 0}[case]
    np.testing.assert_array_equal(got[0], want)
    plain = nms_kernel.nms_mask_sorted_plain(torch.from_numpy(boxes),
                                             torch.from_numpy(valid), 0.4).numpy()
    np.testing.assert_array_equal(plain, got)
    for b in range(2):
        ref = np.asarray(nms_mask_pallas_sorted(jnp.asarray(boxes[b]), jnp.asarray(valid[b]),
                                                0.4, interpret=True))
        np.testing.assert_array_equal(plain[b], ref)


def test_tied_scores_and_valid_holes_match():
    rng = np.random.RandomState(2)
    K = 300
    # heavy overlap and only four distinct scores: the greedy order among
    # ties decides which boxes survive
    boxes = random_boxes(rng, 2, K, span=30.0, size=20.0)
    scores = rng.randint(0, 4, (2, K)).astype(np.float32) / 4
    valid = rng.rand(2, K) > 0.3
    got = port_mask(boxes, scores, 0.4, valid)
    np.testing.assert_array_equal(got, jax_mask(boxes, scores, 0.4, valid))
    assert not got[~valid].any()
    # identical boxes, identical scores: lfdtpu keeps the HIGHER index
    same = np.tile(np.asarray([[0, 0, 10, 10]], np.float32), (1, 3, 1))
    keep = port_mask(same, np.ones((1, 3), np.float32), 0.5, np.ones((1, 3), bool))
    np.testing.assert_array_equal(keep[0], [False, False, True])


def test_batched_nms_class_offset_matches():
    rng = np.random.RandomState(3)
    K = 256
    boxes = random_boxes(rng, 2, K, span=60.0)
    scores = rng.rand(2, K).astype(np.float32)
    labels = rng.randint(0, 3, (2, K)).astype(np.int32)
    valid = rng.rand(2, K) > 0.2
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(labels), 0.45,
                      valid=torch.from_numpy(valid)).numpy()
    for b in range(2):
        ref = np.asarray(JN.batched_nms_jax(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]), jnp.asarray(labels[b]),
            0.45, valid=jnp.asarray(valid[b]), use_pallas=False))
        np.testing.assert_array_equal(got[b], ref)


def test_cpu_wrapper_runs_plain_version():
    rng = np.random.RandomState(4)
    boxes = torch.from_numpy(random_boxes(rng, 1, 50))
    valid = torch.ones(1, 50, dtype=torch.bool)
    before = nms_kernel.nms_mask_sorted.launches
    got = nms_kernel.nms_mask_sorted(boxes, valid, 0.5)
    assert nms_kernel.nms_mask_sorted.launches == before
    assert torch.equal(got, nms_kernel.nms_mask_sorted_plain(boxes, valid, 0.5))
