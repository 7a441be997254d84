# The hand-written CUDA kernels against their plain versions, on the card.
# Every test here is marked `cuda` and skips where there is no CUDA device
# (the CPU test machines); this file imports neither jax nor lfdtpu, so it
# also runs on a GPU machine without them:
#   python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
# (--noconftest: tests/conftest.py sets up jax for the JAX package's tests).
import numpy as np
import pytest
import torch

from lfdtpu_torch.ops import conv_kernels, kernel_lib, nms_kernel
from lfdtpu_torch.ops.nms import nms_mask

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def max_rel(got, ref):
    got, ref = got.float().cpu(), ref.float().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def test_kernels_build_from_sources(cuda):
    kernel_lib.library()
    path = kernel_lib.library_path()
    assert path.exists() and path.name.startswith("liblfd_kernels_")


@pytest.mark.parametrize("K", [1000, 1536])
@pytest.mark.parametrize("case", ["random", "valid holes", "tied scores", "exact iou"])
def test_nms_kernel_matches_plain_exactly(cuda, K, case):
    rng = np.random.RandomState(K)
    if case == "exact iou":  # integer boxes: IoUs land exactly on the threshold
        xy = rng.randint(0, 40, (4, K, 2)) * 2.0
        wh = rng.randint(1, 5, (4, K, 2)) * 2.0
    else:
        xy = rng.rand(4, K, 2) * 12 * K ** 0.5
        wh = rng.rand(4, K, 2) * 60 + 1
    boxes = torch.as_tensor(np.concatenate([xy, xy + wh], -1), dtype=torch.float32,
                            device=cuda)
    scores = (rng.randint(0, 5, (4, K)) / 5.0 if case == "tied scores"
              else rng.rand(4, K))
    scores = torch.as_tensor(scores, dtype=torch.float32, device=cuda)
    valid = torch.as_tensor(rng.rand(4, K) > (0.3 if case == "valid holes" else 0.0),
                            device=cuda)
    thr = 0.5 if case == "exact iou" else 0.4
    before = nms_kernel.nms_mask_sorted.launches
    got = nms_mask(boxes, scores, thr, valid=valid, use_kernel=True)
    ref = nms_mask(boxes, scores, thr, valid=valid, use_kernel=False)
    torch.cuda.synchronize()
    assert nms_kernel.nms_mask_sorted.launches == before + 1
    assert torch.equal(got, ref)
    assert not got[~valid].any()


def k1_case(case, B, K, seed=0):
    """Sorted boxes (B, K, 4) f32 and valid (B, K) bool, CPU tensors: the
    walk's hard cases of `nms_kernel.walk_cases` (a suppression chain, all
    kept, all suppressed), or random boxes."""
    if case != "random":
        return nms_kernel.walk_cases(B, K)[case]
    rng = np.random.RandomState(seed)
    xy = rng.rand(B, K, 2) * 12 * K ** 0.5
    boxes = np.concatenate([xy, xy + 30.0], -1).astype(np.float32)
    return torch.from_numpy(boxes), torch.ones(B, K, dtype=torch.bool)


def _k1_check(cuda, case, B, K):
    boxes, valid = (a.to(cuda) for a in k1_case(case, B, K, seed=K + B))
    got = nms_kernel.nms_mask_sorted(boxes, valid, 0.4)
    ref = nms_kernel.nms_mask_sorted_plain(boxes, valid, 0.4)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    return got.cpu().numpy()


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("K", [1000, 1536])
@pytest.mark.parametrize("case", ["chain", "all kept", "all suppressed"])
def test_nms_kernel_walk_hard_cases(cuda, case, K, B):
    got = _k1_check(cuda, case, B, K)
    want = {"chain": np.arange(K) % 2 == 0, "all kept": np.ones(K, bool),
            "all suppressed": np.arange(K) == 0}[case]
    assert (got == want).all()


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("K", [1, 63, 64, 65])
def test_nms_kernel_small_k(cuda, K, B):
    for case in ("chain", "random", "all suppressed"):
        _k1_check(cuda, case, B, K)


# the walk stages the image's words in shared memory up to K = 1728 and reads
# them from global memory past it
@pytest.mark.parametrize("K", [1000, 1536, 3000])
def test_nms_kernel_staged_and_global_walks(cuda, K):
    before = nms_kernel.nms_mask_sorted.launches
    _k1_check(cuda, "random", 4, K)
    _k1_check(cuda, "chain", 2, K)
    assert nms_kernel.nms_mask_sorted.launches == before + 2


@pytest.mark.parametrize("K", [1000, 3000])
def test_nms_kernel_graph_replays_match_eager(cuda, K):
    """Two replays of a CUDA graph holding the launch (the walk a programmatic
    dependent launch) give the eager mask."""
    boxes, valid = (a.to(cuda) for a in k1_case("random", 4, K))
    eager = nms_kernel.nms_mask_sorted(boxes, valid, 0.4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nms_kernel.nms_mask_sorted(boxes, valid, 0.4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = nms_kernel.nms_mask_sorted(boxes, valid, 0.4)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_nms_kernel_rejects_bad_input(cuda):
    boxes = torch.zeros(1, 8, 4, device=cuda, dtype=torch.float64)
    valid = torch.ones(1, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        nms_kernel.nms_mask_sorted(boxes, valid, 0.5)


@pytest.mark.parametrize("hw", [(272, 480), (37, 50), (8, 16), (1, 3)])
@pytest.mark.parametrize("residual,relu", [(True, True), (False, True), (False, False)])
def test_pair_conv_kernel_matches_plain(cuda, hw, residual, relu):
    g = torch.Generator(device=cuda).manual_seed(hw[0])
    x = torch.randn(2, *hw, 64, device=cuda, generator=g).bfloat16()
    w = (torch.randn(3, 3, 64, 64, device=cuda, generator=g) * 0.05).bfloat16()
    s = torch.rand(64, device=cuda, generator=g) + 0.5
    b = torch.randn(64, device=cuda, generator=g) * 0.1
    res = x.flip(0).contiguous() if residual else None
    got = conv_kernels.pair_conv3x3(x, w, s, b, residual=res, relu=relu)
    ref = conv_kernels.pair_conv3x3_plain(x, w, s, b, residual=res, relu=relu)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert max_rel(got, ref) < 0.02


@pytest.mark.parametrize("hw", [(1088, 1920), (41, 66), (13, 22), (2, 2)])
def test_stem_kernel_matches_plain(cuda, hw):
    g = torch.Generator(device=cuda).manual_seed(hw[1])
    frame = torch.randint(0, 256, (2, *hw, 3), device=cuda, generator=g,
                          dtype=torch.uint8)
    w = torch.randn(3, 3, 3, 64, device=cuda, generator=g) * 0.1
    mean = torch.tensor([100.0, 110.0, 120.0], device=cuda)
    std = torch.tensor([50.0, 55.0, 60.0], device=cuda)
    s = torch.rand(64, device=cuda, generator=g) + 0.5
    b = torch.randn(64, device=cuda, generator=g) * 0.1
    got = conv_kernels.stem_conv(frame, w, mean, std, s, b)
    ref = conv_kernels.stem_conv_plain(frame, w, mean, std, s, b)
    torch.cuda.synchronize()
    assert got.shape == (2, (hw[0] + 1) // 2, (hw[1] + 1) // 2, 64)
    assert max_rel(got, ref) < 0.03


def _k3_inputs(cuda, n, hw, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, *hw, 64, device=cuda, generator=g).bfloat16()
    w = (torch.randn(3, 3, 64, 64, device=cuda, generator=g) * 0.05).bfloat16()
    s = torch.rand(64, device=cuda, generator=g) + 0.5
    b = torch.randn(64, device=cuda, generator=g) * 0.1
    return x, w, s, b


def _k2_inputs(cuda, n, hw, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    frame = torch.randint(0, 256, (n, *hw, 3), device=cuda, generator=g, dtype=torch.uint8)
    w = torch.randn(3, 3, 3, 64, device=cuda, generator=g) * 0.1
    mean = torch.tensor([100.0, 110.0, 120.0], device=cuda)
    std = torch.tensor([50.0, 55.0, 60.0], device=cuda)
    s = torch.rand(64, device=cuda, generator=g) + 0.5
    b = torch.randn(64, device=cuda, generator=g) * 0.1
    return frame, w, mean, std, s, b


# the engine's three K3 shapes at 1088x1920, at batch 4 (the bf16_kernels_b4
# engine), and shapes with a partial tile in every dimension or fewer 8x32
# tiles than SMs, which take each of the kernel's three item shapes (8x32x64,
# 8x32x32 at 68x120, 4x32x32 at the smallest)
@pytest.mark.parametrize("n,hw", [(4, (272, 480)), (4, (136, 240)), (4, (68, 120)),
                                  (1, (1, 1)), (1, (5, 7)), (1, (68, 120)),
                                  (1, (136, 240))])
@pytest.mark.parametrize("residual", [True, False])
def test_pair_conv_kernel_matches_plain_at_engine_and_partial_shapes(cuda, n, hw, residual):
    x, w, s, b = _k3_inputs(cuda, n, hw, hw[0] * 7 + n)
    res = x.roll(1, 0).contiguous() if residual else None
    got = conv_kernels.pair_conv3x3(x, w, s, b, residual=res, relu=True)
    ref = conv_kernels.pair_conv3x3_plain(x, w, s, b, residual=res, relu=True)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert max_rel(got, ref) < 0.02


@pytest.mark.parametrize("n,hw", [(4, (1088, 1920)), (1, (1087, 1919)), (1, (3, 5))])
def test_stem_kernel_matches_plain_at_batch_and_odd_shapes(cuda, n, hw):
    args = _k2_inputs(cuda, n, hw, hw[1] + n)
    got = conv_kernels.stem_conv(*args)
    ref = conv_kernels.stem_conv_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (n, (hw[0] + 1) // 2, (hw[1] + 1) // 2, 64)
    assert max_rel(got, ref) < 0.03


def test_conv_kernels_are_deterministic(cuda):
    """Two launches on the same inputs give bitwise equal outputs: a race in
    the ring of input windows or the staging tiles would show here."""
    x, w, s, b = _k3_inputs(cuda, 2, (272, 480), 3)
    k3 = [conv_kernels.pair_conv3x3(x, w, s, b, residual=x, relu=True) for _ in range(2)]
    small = _k3_inputs(cuda, 1, (68, 120), 4)
    k3s = [conv_kernels.pair_conv3x3(*small, relu=False) for _ in range(2)]
    args = _k2_inputs(cuda, 2, (1088, 1920), 5)
    k2 = [conv_kernels.stem_conv(*args) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in (k3, k3s, k2):
        assert torch.equal(a, b_)


def test_conv_kernels_reject_bad_input(cuda):
    x = torch.zeros(1, 8, 8, 64, device=cuda)  # float32, not bf16
    w = torch.zeros(3, 3, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        conv_kernels.pair_conv3x3(x, w, torch.ones(64, device=cuda),
                                  torch.zeros(64, device=cuda))
    nhwc = torch.zeros(1, 8, 8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        conv_kernels.pair_conv3x3(nhwc.transpose(1, 2), w, torch.ones(64, device=cuda),
                                  torch.zeros(64, device=cuda))


def _shm_batches(loader, device, keys):
    from lfdtpu_torch.execution import set_random_seed
    from lfdtpu_torch.parallel import prefetch_to_device

    set_random_seed(5)
    if device is None:  # read batch by batch: copy, then release
        out = []
        for batch in loader:
            out.append({k: np.array(batch[k]) for k in keys})
            loader.release_slot(batch)
        return out
    return [{k: v.cpu().numpy() for k, v in b.items() if k in keys}
            for b in prefetch_to_device(loader, device, size=2, keys=keys)]


def test_prefetch_to_cuda_releases_shm_slots_after_the_copy(cuda):
    """A ShmDataLoader with 2 slots through prefetch_to_device on the card:
    each slot released once it is copied into pinned staging, the
    asynchronous copies reading only that staging; every batch equals the
    batch-by-batch read of the same seed, and every slot is back at the end."""
    from lfdtpu_torch import data as tdata

    rng = np.random.RandomState(4)
    samples = {i: dict(image=rng.randint(0, 256, (90 + i, 120, 3)).astype(np.uint8),
                       bboxes=[[10 + i, 20, 30, 25]], bbox_labels=[0]) for i in range(24)}
    ds = type("DS", (), {"__getitem__": lambda self, i: samples[i],
                         "__len__": lambda self: len(samples),
                         "get_indexes": lambda self: list(samples)})()
    keys = ("images", "gt_bboxes", "gt_labels", "gt_mask") + tdata.AUG_KEYS

    def loader():
        region = tdata.DeviceAugRegionSampler(
            tdata.RandomBBoxCropRegionSampler(crop_size=48, resize_range=(0.6, 1.5)))
        return tdata.ShmDataLoader(ds, tdata.RandomDatasetSampler(ds, batch_size=4, seed=9),
                                   region, num_workers=1, max_boxes_per_image=4, num_slots=2)

    ref_loader, gpu_loader = loader(), loader()
    try:
        ref = _shm_batches(ref_loader, None, keys)
        got = _shm_batches(gpu_loader, cuda, keys)
        assert gpu_loader._free_slots.qsize() == gpu_loader.num_slots
    finally:
        ref_loader.close()
        gpu_loader.close()
    assert len(got) == len(ref) == 6
    for a, b in zip(got, ref):
        for k in keys:
            assert np.array_equal(a[k], np.asarray(b[k], a[k].dtype)), k


def test_device_augment_on_the_card_matches_the_cpu(cuda):
    from lfdtpu_torch.data import make_device_augment

    rng = np.random.RandomState(2)
    batch = dict(buffer=rng.randint(0, 256, (8, 192, 192, 3)).astype(np.uint8),
                 scale=rng.uniform(0.4, 2.5, (8, 2)).astype(np.float32),
                 translation=rng.uniform(-200, 60, (8, 2)).astype(np.float32),
                 flip=(np.arange(8) % 2).astype(np.float32))
    cpu = {k: torch.as_tensor(v) for k, v in batch.items()}
    for dtype in (torch.float32, torch.bfloat16):
        aug = make_device_augment(96, compute_dtype=dtype)
        ref = aug(cpu).float()
        got = aug({k: v.to(cuda) for k, v in cpu.items()}).float().cpu()
        assert (got - ref).abs().max() <= (1e-3 if dtype == torch.float32 else 1.0)
