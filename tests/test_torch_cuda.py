# The hand-written CUDA kernels against their plain versions, on the card.
# Every test here is marked `cuda` and skips where there is no CUDA device
# (the CPU test machines); this file imports neither jax nor lfdtpu, so it
# also runs on a GPU machine without them:
#   python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py
# (--noconftest: tests/conftest.py sets up jax for the JAX package's tests).
import numpy as np
import pytest
import torch

from lfdtpu_torch.deploy.kernel_net import group_norm_calls
from lfdtpu_torch.ops import conv_kernels, group_norm, kernel_lib, nms_kernel
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
@pytest.mark.parametrize("case", ["random", "valid holes", "tied scores", "tied holes",
                                  "exact iou"])
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
    scores = (rng.randint(0, 5, (4, K)) / 5.0 if case.startswith("tied")
              else rng.rand(4, K))
    scores = torch.as_tensor(scores, dtype=torch.float32, device=cuda)
    holes = {"valid holes": 0.3, "tied holes": 0.1}.get(case, 0.0)
    valid = torch.as_tensor(rng.rand(4, K) > holes, device=cuda)
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


# the engine's three K3 shapes at 1088x1920, at batch 1 and 4 (the
# bf16_kernels_b4 engine), and shapes with a partial tile in every dimension
# or fewer 8x32 tiles than SMs, which take each of the kernel's three item
# shapes (8x32x64, 8x32x32 at 68x120, 4x32x32 at the smallest)
@pytest.mark.parametrize("n,hw", [(4, (272, 480)), (4, (136, 240)), (4, (68, 120)),
                                  (1, (1, 1)), (1, (5, 7)), (1, (68, 120)),
                                  (1, (136, 240)), (1, (272, 480))])
@pytest.mark.parametrize("residual,relu", [(True, True), (False, True), (False, False)])
def test_pair_conv_kernel_matches_plain_at_engine_and_partial_shapes(cuda, n, hw, residual,
                                                                     relu):
    x, w, s, b = _k3_inputs(cuda, n, hw, hw[0] * 7 + n)
    res = x.roll(1, 0).contiguous() if residual else None
    got = conv_kernels.pair_conv3x3(x, w, s, b, residual=res, relu=relu)
    ref = conv_kernels.pair_conv3x3_plain(x, w, s, b, residual=res, relu=relu)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert max_rel(got, ref) < 0.02


@pytest.mark.parametrize("n,hw", [(4, (1088, 1920)), (1, (1088, 1920)), (1, (1087, 1919)),
                                  (1, (3, 5))])
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


# ---------------------------------------------------------------- engines
# The captured (CUDA-graph) engine against the eager engine of the same
# build, on the card: the same kernels in the same order on the same inputs,
# so every output tensor must be bit-equal.

ENGINE_HW = (256, 320)
FULL_HW = (1088, 1920)  # 1080p padded to the stride-64 multiple, as served
# (frame shape, batch) of the engine tests: a small map, and 1080p at batch 1
# and at batch 4 (the bf16_kernels_b4 engine)
ENGINE_SHAPES = [(ENGINE_HW, 2), (FULL_HW, 1), (FULL_HW, 4)]
ENGINE_VARIANTS = {
    "fp32": dict(precision="fp32"),
    "bf16": dict(precision="bf16"),
    "bf16_kernels": dict(precision="bf16", kernel_convs=True, kernel_stem=True),
    "bf16_plain": dict(precision="bf16", nms_use_kernel=False),
}


def _detector(size, seed=0, **kw):
    """A WIDERFACE detector (or the zoo's `name`) with seeded weights and
    randomized norm statistics, affines and head Scales (so BN folding is
    exercised)."""
    from chip_smoke import build_detector

    return build_detector("cpu", seed=seed, size=size, **kw)


def _engine(det, variant, hw=ENGINE_HW, batch_size=2, **kw):
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    return compile_inference(det, hw, preprocess=make_device_preprocess((0.5,) * 3, (0.5,) * 3),
                             batch_size=batch_size, **ENGINE_VARIANTS[variant], **kw)


def _frames(seed, batch=2, hw=ENGINE_HW):
    return np.random.RandomState(seed).randint(0, 256, (batch, *hw, 3)).astype(np.uint8)


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _extents(hw, batch):
    """Each frame's valid (height, width): the whole frame, then smaller
    (at ENGINE_HW batch 2: [[256, 320], [200, 311]])."""
    return np.asarray([[hw[0] - 56 * i, hw[1] - 9 * i] for i in range(batch)], np.float32)


@pytest.mark.parametrize("hw,batch", ENGINE_SHAPES)
@pytest.mark.parametrize("variant", list(ENGINE_VARIANTS))
@pytest.mark.parametrize("size", ["S", "L"])
def test_captured_engine_rows_equal_eager(cuda, size, variant, hw, batch):
    det = _detector(size)
    captured = _engine(det, variant, hw, batch)  # the default on the card
    eager = _engine(det, variant, hw, batch, captured=False)
    assert captured.captured and not eager.captured
    k3 = 10  # five eligible FasterBlocks in S and in L, two launches each
    assert captured.captured_launches == {
        "nms_mask_sorted": int(variant != "bf16_plain"),
        "stem_conv": int(variant == "bf16_kernels"),
        "pair_conv3x3": k3 * int(variant == "bf16_kernels"),
        "int8_conv": 0, "group_norm_relu": group_norm_calls(det.net)}
    vhw = _extents(hw, batch)
    before = nms_kernel.nms_mask_sorted.launches
    outs = []
    for seed in (1, 2):
        f = _frames(seed, batch, hw)
        got = captured(f, vhw)
        ref = eager(f, vhw)
        # a frame and extents already on the card take the other input path
        again = captured(torch.as_tensor(f, device=cuda), torch.as_tensor(vhw, device=cuda))
        outs.append((got, again, ref))
    for seed, (got, again, ref) in zip((1, 2), outs):  # the first results survive
        assert int(got["count"].sum()) > 0
        assert _same(got, ref) and _same(again, ref), (size, variant, hw, batch, seed)
    assert not torch.equal(outs[0][0]["scores"], outs[1][0]["scores"])
    # a replay launches kernels without the wrappers: only the eager engine counted
    assert nms_kernel.nms_mask_sorted.launches == before + 2 * int(variant != "bf16_plain")


def test_captured_engine_results_survive_the_next_call(cuda):
    det = _detector("S")
    engine = _engine(det, "bf16_kernels", pack_output=True)
    eager = _engine(det, "bf16_kernels", pack_output=True, captured=False)
    f1, f2 = _frames(3), _frames(4)
    r1 = engine(f1, ENGINE_HW)
    kept = r1.clone()
    r2 = engine(f2, ENGINE_HW)
    torch.cuda.synchronize()
    assert r1.shape == (2, det.post_nms_bbox_limit, 7)
    assert torch.equal(r1, kept) and not torch.equal(r1, r2)
    assert torch.equal(r1, eager(f1, ENGINE_HW)) and torch.equal(r2, eager(f2, ENGINE_HW))
    # the caller's arrays are free to change as soon as the call returns
    f3 = _frames(5)
    want = eager(f3, ENGINE_HW)
    r3 = engine(f3, ENGINE_HW)
    f3[:] = 0
    assert torch.equal(r3, want)


def test_two_captured_engines_alive_at_once(cuda):
    det_s, det_l = _detector("S"), _detector("L", seed=1)
    a = _engine(det_s, "bf16_kernels")
    b = _engine(det_l, "bf16_kernels", hw=(192, 256), batch_size=1)
    ea = _engine(det_s, "bf16_kernels", captured=False)
    eb = _engine(det_l, "bf16_kernels", hw=(192, 256), batch_size=1, captured=False)
    outs = []
    for seed in (6, 7, 8):  # interleaved: neither graph disturbs the other's buffers
        fa, fb = _frames(seed), _frames(seed + 10, 1, (192, 256))
        outs.append((a(fa, ENGINE_HW), ea(fa, ENGINE_HW), b(fb, (192, 256)), eb(fb, (192, 256))))
    for ra, wa, rb, wb in outs:
        assert _same(ra, wa) and _same(rb, wb)


def test_captured_engine_called_from_another_stream(cuda):
    det = _detector("S")
    engine = _engine(det, "bf16_kernels")
    eager = _engine(det, "bf16_kernels", captured=False)
    f1, f2 = _frames(9), _frames(10)
    want1, want2 = eager(f1, ENGINE_HW), eager(f2, ENGINE_HW)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got1 = engine(f1, ENGINE_HW)
        got2 = engine(torch.as_tensor(f2).to(cuda, non_blocking=True), ENGINE_HW)
    side.synchronize()
    assert _same(got1, want1) and _same(got2, want2)
    back = engine(f1, ENGINE_HW)  # and on the default stream again
    assert _same(back, want1)


def test_captured_engine_refuses_what_it_was_not_built_for(cuda):
    engine = _engine(_detector("S"), "bf16")
    with pytest.raises(ValueError, match="batch_size"):
        engine(_frames(1, batch=1), ENGINE_HW)
    with pytest.raises(ValueError, match="expected"):
        engine(_frames(1, hw=(128, 128)), ENGINE_HW)
    stem = _engine(_detector("S"), "bf16_kernels")  # the stem kernel takes raw uint8 only
    with pytest.raises(ValueError, match="uint8"):
        stem(_frames(1).astype(np.float32), ENGINE_HW)
    with pytest.raises(ValueError, match="uint8"):
        stem(torch.zeros(2, *ENGINE_HW, 3, device=cuda), ENGINE_HW)
    assert int(engine(_frames(1), ENGINE_HW)["count"].sum()) > 0  # still serves
    assert int(stem(_frames(1), ENGINE_HW)["count"].sum()) > 0


@pytest.mark.parametrize("hw,batch", [(ENGINE_HW, 2), (FULL_HW, 1)])
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_captured_engine_serves_float_frames(cuda, precision, hw, batch):
    """Frames normalized on the host (float32, no device preprocess): the
    captured engine captures a float graph at the first float call and
    returns the eager engine's rows, from the host and from the card, while
    its uint8 graph goes on serving; predict_for_*_with_engine with a
    host-normalizing pipeline works on it."""
    from lfdtpu_torch.data.augmentation import Compose, Normalize
    from lfdtpu_torch.deploy import compile_inference

    det = _detector("S")
    kw = dict(batch_size=batch, classification_threshold=1e-4)
    engine = compile_inference(det, hw, precision, **kw)
    if precision == "int8":
        kw["act_scales"] = engine.int8_chain.amax
    eager = compile_inference(det, hw, precision, captured=False, **kw)
    assert engine.captured and set(engine._graphs) == {torch.uint8}
    norm = Compose([Normalize((0.5,) * 3, (0.5,) * 3)])
    f = norm({"image": _frames(13, batch, hw)})["image"]
    assert f.dtype == np.float32
    vhw = _extents(hw, batch)
    ref = eager(f, vhw)
    assert int(ref["count"].sum()) > 0
    assert _same(engine(f, vhw), ref)
    assert set(engine._graphs) == {torch.uint8, torch.float32}
    assert _same(engine(torch.as_tensor(f, device=cuda), torch.as_tensor(vhw, device=cuda)), ref)
    assert _same(engine(f.astype(np.float64), vhw), ref)  # reaches the net as float32
    u = _frames(14, batch, hw)
    assert _same(engine(u, vhw), eager(u, vhw))
    assert _same(engine(f, vhw), ref)
    one = compile_inference(det, hw, precision, **dict(kw, batch_size=1))
    one_eager = compile_inference(det, hw, precision, captured=False,
                                  **dict(kw, batch_size=1))
    img = _frames(15, 1, (hw[0] - 56, hw[1] - 20))[0]
    rows = det.predict_for_single_image_with_engine(one, img, aug_pipeline=norm)
    assert rows and rows == det.predict_for_single_image_with_engine(one_eager, img,
                                                                     aug_pipeline=norm)


def test_a_capture_that_cannot_succeed_raises(cuda, monkeypatch):
    """A host sync inside what is captured: compile_inference raises, hands
    back no engine, and the next capture works."""
    from lfdtpu_torch.deploy import compile as compile_mod

    det = _detector("S")
    real = compile_mod.EngineProgram.decode
    state = {"calls": 0}

    def syncing(self, outputs, vhw):
        state["calls"] += 1
        if torch.cuda.is_current_stream_capturing():
            outputs[0].sum().item()  # a host sync: not permitted in a capture
        return real(self, outputs, vhw)

    monkeypatch.setattr(compile_mod.EngineProgram, "decode", syncing)
    with pytest.raises(RuntimeError, match="capturing the engine"):
        _engine(det, "bf16_kernels")
    assert state["calls"] > 1  # the warmup calls ran eagerly before the capture
    assert _engine(det, "bf16_kernels", captured=False).captured is False  # eager on request
    monkeypatch.setattr(compile_mod.EngineProgram, "decode", real)
    engine = _engine(det, "bf16_kernels")
    f = _frames(11)
    assert engine.captured
    assert _same(engine(f, ENGINE_HW), _engine(det, "bf16_kernels", captured=False)(f, ENGINE_HW))


@pytest.mark.parametrize("sweep", [None, "L bf16", "XS bf16", "L int8"])
def test_timing_inference_on_the_card(cuda, sweep):
    """timing_inference on one captured engine; with `sweep`, that WIDERFACE
    size and precision through inference_latency_evaluation at its four
    resolutions (640x480 to 4K), one captured engine per cell."""
    from lfdtpu_torch.deploy import (inference_latency_evaluation, make_device_preprocess,
                                     timing_inference)

    if sweep is None:
        engine = _engine(_detector("S"), "bf16_kernels", batch_size=1)
        cells = [timing_inference(engine, _frames(12, 1), ENGINE_HW, warmup_loops=3,
                                  timing_loops=10)]
    else:
        size, precision = sweep.split()
        cells = inference_latency_evaluation(
            _detector(size), precisions=(precision,),
            preprocess=make_device_preprocess((0.5,) * 3, (0.5,) * 3), warmup_loops=3,
            timing_loops=10, verbose=False, device=cuda).values()
        assert len(cells) == 4
    for r in cells:
        assert r["method"] == "cuda_events_per_call" and r["loops"] == 10
        assert np.isfinite([v for v in r.values() if not isinstance(v, str)]).all()
        assert 0 < r["ms_min"] <= r["ms_per_image"] <= r["ms_p95"]


# ------------------------------------------------------- traffic and LFDv2
# The TT100K, TrafficLight and LFDv2 paths on the card: K3 at TT100K's
# 2048x2048 levels, K2 with TL's BGR -> RGB and imagenet constants folded in,
# K1 behind 45 class offsets, and their captured engines against eager ones.

@pytest.mark.parametrize("n,hw", [(1, (512, 512)), (4, (512, 512)), (1, (256, 256)),
                                  (4, (256, 256)), (1, (128, 128)), (4, (128, 128))])
@pytest.mark.parametrize("residual,relu", [(True, True), (False, True), (False, False)])
def test_pair_conv_kernel_matches_plain_at_tt100k_shapes(cuda, n, hw, residual, relu):
    x, w, s, b = _k3_inputs(cuda, n, hw, hw[0] + n)
    res = x.roll(1, 0).contiguous() if residual else None
    got = conv_kernels.pair_conv3x3(x, w, s, b, residual=res, relu=relu)
    ref = conv_kernels.pair_conv3x3_plain(x, w, s, b, residual=res, relu=relu)
    torch.cuda.synchronize()
    assert max_rel(got, ref) < 0.02


@pytest.mark.parametrize("n,hw", [(1, (768, 1280)), (4, (768, 1280)), (1, (2048, 2048)),
                                  (4, (2048, 2048))])
def test_stem_kernel_with_tl_folded_constants_matches_plain(cuda, n, hw):
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    det = _detector(None, name="TL-L")
    pre = make_device_preprocess((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), bgr2rgb=True)
    engine = compile_inference(det, (64, 64), "bf16", preprocess=pre, kernel_stem=True,
                               captured=False)
    pack = engine.net._backbone.fused_stem.pack
    frame = _k2_inputs(cuda, n, hw, n)[0]
    got = conv_kernels.stem_conv(frame, *pack)
    ref = conv_kernels.stem_conv_plain(frame, *pack)
    torch.cuda.synchronize()
    assert max_rel(got, ref) < 0.03


def test_batched_nms_kernel_at_45_classes_matches_plain(cuda):
    from lfdtpu_torch.ops.nms import batched_nms

    rng = np.random.RandomState(45)
    xy = rng.rand(4, 1000, 2) * 1900
    boxes = np.concatenate([xy, xy + rng.rand(4, 1000, 2) * 150 + 1], -1)
    boxes[:, 500:] = boxes[:, :500] + rng.randn(4, 500, 4) * 4
    labels = rng.randint(0, 45, (4, 1000))
    labels[:, 500:] = labels[:, :500]
    args = [torch.as_tensor(a, device=cuda) for a in (
        np.clip(boxes, 0, 2048).astype(np.float32), rng.rand(4, 1000).astype(np.float32),
        labels.astype(np.int32))]
    valid = torch.as_tensor(rng.rand(4, 1000) > 0.1, device=cuda)
    got = batched_nms(*args, 0.5, valid=valid, use_kernel=True)
    ref = batched_nms(*args, 0.5, valid=valid, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.parametrize("name", ["TT100K-L", "TL-L", "TL-S", "LFDv2"])
def test_traffic_and_lfdv2_captured_engines_equal_eager(cuda, name):
    from chip_smoke import (IMAGENET, VARIANTS, expected_launches, kernel_variant,
                            lfdv2_detector)
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess
    from lfdtpu_torch.models import LFDv2

    if name == "LFDv2":
        det, pre, kw = lfdv2_detector(LFDv2, "cpu"), make_device_preprocess((0.5,) * 3,
                                                                            (0.5,) * 3), {}
    else:
        det = _detector(None, name=name, cls_std=0.2)
        pre = (make_device_preprocess((0.5,) * 3, (0.5,) * 3) if name.startswith("TT")
               else make_device_preprocess(*IMAGENET, bgr2rgb=True))
        kw = {} if name.startswith("TT") else dict(class_agnostic=True)
    variant = kernel_variant(det)
    engines = [compile_inference(det, ENGINE_HW, preprocess=pre, batch_size=2, captured=c,
                                 **VARIANTS[variant], **kw) for c in (None, False)]
    assert engines[0].captured and not engines[1].captured
    assert engines[0].captured_launches == expected_launches(det, VARIANTS[variant])
    vhw = np.asarray([[256, 320], [200, 311]], np.float32)
    for seed in (1, 2):
        f = _frames(seed)
        got, ref = engines[0](f, vhw), engines[1](f, vhw)
        assert int(got["count"].sum()) > 0 and _same(got, ref), (name, seed)


def test_fcos_decode_with_k1_equals_plain_at_80_classes(cuda):
    # FCOS-R50-FPN (chip_smoke.fcos_r50_fpn) at 256x384: K1 behind 80 class
    # offsets with the centerness factors, rows identical to the plain NMS
    import dataclasses

    from chip_smoke import fcos_r50_fpn
    from lfdtpu_torch.models.detector import eval_forward

    det = fcos_r50_fpn(cuda, seed=3)
    spec = det.decode_spec()
    x = torch.as_tensor(_frames(3, 1, (256, 384)), dtype=torch.float32, device=cuda)
    outs = tuple(o[0] for o in eval_forward(det.net, x))
    before = nms_kernel.nms_mask_sorted.launches
    with torch.inference_mode():
        got = det.decode_single(outs, (256, 384), (250, 380), spec)
        ref = det.decode_single(outs, (256, 384), (250, 380),
                                dataclasses.replace(spec, nms_use_kernel=False))
    assert nms_kernel.nms_mask_sorted.launches == before + 1
    assert int(got["count"]) > 0 and all(torch.equal(got[k], ref[k]) for k in got)


# ---------------------------------------------------------------- K4 (int8)

# (Cin, Cout, kernel, stride, hw): every kernel size, stride, Cin and Cout of
# the zoo's int8 chain, at odd sizes too
K4_SHAPES = [(3, 64, 3, 2, (67, 93)), (3, 48, 3, 2, (40, 64)), (3, 32, 3, 2, (33, 31)),
             (64, 64, 1, 1, (34, 60)), (64, 64, 3, 1, (68, 120)), (64, 64, 3, 2, (37, 50)),
             (64, 64, 1, 2, (37, 50)), (64, 128, 1, 1, (17, 30)), (128, 128, 3, 1, (17, 30)),
             (128, 128, 1, 1, (9, 15)), (48, 48, 3, 1, (20, 33)), (48, 64, 3, 2, (20, 33)),
             (32, 32, 3, 1, (16, 16)), (32, 64, 1, 2, (16, 16)), (64, 32, 3, 1, (8, 8)),
             # the smallest LFDs' 8 / 16 channels, and a flat layout over 9 K steps
             (3, 8, 3, 2, (33, 31)), (8, 16, 3, 2, (17, 16)), (16, 8, 3, 2, (17, 16)),
             (16, 24, 1, 1, (9, 9)), (24, 96, 3, 1, (9, 9))]


def _mma_shapes():
    from chip_smoke import K4_MMA_SHAPES

    return K4_MMA_SHAPES


def _k4_inputs(cuda, cin, cout, k, stride, hw, seed, batch=2):
    from lfdtpu_torch.ops import int8_conv as k4

    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randint(-127, 128, (batch, *hw, cin), device=cuda, generator=g).to(torch.int8)
    w = torch.randn(cout, cin, k, k, device=cuda, generator=g)
    q, w_scale = k4.quantize_weights(w)
    mult = (w_scale * 0.02 / (cin * k * k) ** 0.5).float().contiguous()
    bias = (torch.randn(cout, device=cuda, generator=g) * 0.1).contiguous()
    return x, k4.pack_int8_weight(q), mult, bias


@pytest.mark.parametrize("cin,cout,k,stride,hw", K4_SHAPES)
@pytest.mark.parametrize("mode", ["a", "a relu", "b", "c int8", "c f32"])
def test_int8_conv_kernel_matches_plain_exactly(cuda, cin, cout, k, stride, hw, mode):
    from lfdtpu_torch.ops import int8_conv as k4

    x, wp, mult, bias = _k4_inputs(cuda, cin, cout, k, stride, hw, seed=cin + cout + k)
    ho, wo = k4.out_hw(*hw, k, stride)
    kw = dict(relu="relu" in mode)
    if mode != "b":
        kw["out_scale"] = 0.02
    if mode == "c int8":
        g = torch.Generator(device=cuda).manual_seed(1)
        kw["residual"] = torch.randint(-127, 128, (2, ho, wo, cout), device=cuda,
                                       generator=g).to(torch.int8)
        kw["residual_scale"] = 0.013
    elif mode == "c f32":
        kw["residual"] = torch.randn(2, ho, wo, cout, device=cuda)
    before = k4.int8_conv.launches
    got = k4.int8_conv(x, wp, mult, bias, k, stride, **kw)
    ref = k4.int8_conv_plain(x, wp, mult, bias, k, stride, **kw)
    torch.cuda.synchronize()
    assert k4.int8_conv.launches == before + 1
    assert got.shape == ref.shape == (2, ho, wo, cout) and got.dtype == ref.dtype
    assert torch.equal(got, ref), (mode, (got.float() - ref.float()).abs().max())
    if got.dtype == torch.int8:  # the requant spans the range, not one value
        assert int(got.max()) == 127 and len(torch.unique(got)) > 100


# the wgmma and stem routes' edges: a level smaller than one tile, ragged
# last tiles, 3x3 128 -> 128 with its 147 KB of resident weights, stride-2
# windows at odd sizes, batch 4; at 32 and 48 channels the same (32-byte tap
# rows, 48-channel taps padded to 64 bytes by TMA, 48-channel outputs in
# 64-byte tile rows), 48 -> 128 1x1, 32 -> 64 1x1/s2 (the shortcut's f32
# out), and the 3 -> 32 and 3 -> 48 stems (n, Cin, Cout, kernel, stride, hw)
K4_EDGES = [(1, 64, 64, 3, 1, (17, 30)), (1, 128, 128, 1, 1, (17, 30)),
            (1, 64, 64, 3, 1, (35, 61)), (1, 64, 128, 1, 1, (33, 47)),
            (1, 128, 128, 3, 1, (34, 60)), (2, 128, 128, 3, 1, (11, 97)),
            (1, 64, 64, 3, 2, (69, 121)), (1, 128, 128, 3, 2, (35, 61)),
            (1, 64, 128, 3, 2, (67, 119)), (1, 64, 64, 1, 2, (69, 121)),
            (1, 128, 128, 1, 2, (33, 59)), (1, 128, 64, 3, 1, (21, 40)),
            (4, 64, 64, 3, 1, (68, 120)), (4, 64, 64, 1, 2, (136, 240)),
            (4, 128, 128, 3, 2, (34, 60)), (4, 64, 128, 1, 1, (17, 30)),
            (1, 3, 64, 3, 2, (1087, 1919)), (4, 3, 64, 3, 2, (135, 241)),
            (1, 3, 64, 3, 2, (3, 5)),
            (1, 32, 32, 3, 1, (5, 20)), (1, 48, 48, 1, 1, (3, 17)),
            (1, 32, 32, 1, 1, (35, 61)), (1, 48, 48, 3, 1, (35, 61)),
            (2, 48, 48, 1, 1, (33, 47)), (1, 32, 32, 3, 2, (69, 121)),
            (1, 48, 48, 3, 2, (67, 119)), (1, 48, 48, 1, 2, (69, 121)),
            (1, 32, 64, 3, 2, (35, 61)), (1, 48, 64, 3, 2, (37, 63)),
            (1, 48, 64, 1, 2, (37, 63)), (4, 48, 48, 3, 1, (24, 40)),
            (4, 32, 32, 1, 1, (68, 120)), (4, 32, 32, 3, 2, (69, 121)),
            (1, 48, 128, 1, 1, (48, 80)), (1, 32, 64, 1, 2, (69, 121)),
            (1, 64, 48, 3, 1, (21, 40)), (1, 128, 32, 1, 1, (17, 30)),
            (1, 48, 32, 3, 1, (19, 33)), (1, 32, 128, 3, 2, (33, 59)),
            (1, 3, 32, 3, 2, (1087, 1919)), (1, 3, 48, 3, 2, (1087, 1919)),
            (1, 3, 32, 3, 2, (3, 5)), (1, 3, 48, 3, 2, (3, 5)),
            (4, 3, 48, 3, 2, (135, 241))]


@pytest.mark.parametrize("n,cin,cout,k,stride,hw", K4_EDGES)
@pytest.mark.parametrize("mode", ["a", "a relu", "b", "c int8", "c f32"])
def test_int8_conv_routes_match_plain_at_their_edges(cuda, n, cin, cout, k, stride, hw, mode):
    from lfdtpu_torch.ops import int8_conv as k4

    x, wp, mult, bias = _k4_inputs(cuda, cin, cout, k, stride, hw, seed=n + cin + k, batch=n)
    ho, wo = k4.out_hw(*hw, k, stride)
    kw = dict(relu="relu" in mode)
    if mode != "b":
        kw["out_scale"] = 0.02
    g = torch.Generator(device=cuda).manual_seed(2)
    if mode == "c int8":
        kw["residual"] = torch.randint(-127, 128, (n, ho, wo, cout), device=cuda,
                                       generator=g).to(torch.int8)
        kw["residual_scale"] = 0.013
    elif mode == "c f32":
        kw["residual"] = torch.randn(n, ho, wo, cout, device=cuda, generator=g)
    route = k4.route_of(cin, cout, k, stride)
    assert route in ("stem", "wgmma")  # the edges of the routes that the chains take
    before = dict(k4.int8_conv.routes)
    got = k4.int8_conv(x, wp, mult, bias, k, stride, **kw)
    ref = k4.int8_conv_plain(x, wp, mult, bias, k, stride, **kw)
    torch.cuda.synchronize()
    assert k4.int8_conv.routes == dict(before, **{route: before[route] + 1})
    assert got.shape == ref.shape == (n, ho, wo, cout) and got.dtype == ref.dtype
    assert torch.equal(got, ref), (mode, (got.float() - ref.float()).abs().max())


def test_int8_conv_48_channel_taps_read_zeros_past_48(cuda):
    """A 48-channel tap reaches the wgmma route's math as 64 bytes: TMA fills
    bytes 48-63 of each pixel with zeros, never a neighbour pixel's bytes.
    With weights whose padding (bytes 48-63 of each packed tap row) is not
    zero, the kernel still equals the plain version, which drops it."""
    from lfdtpu_torch.ops import int8_conv as k4

    for k, stride, hw in ((3, 1, (35, 61)), (1, 1, (17, 40)), (1, 2, (37, 63)), (3, 2, (33, 47))):
        x, wp, mult, bias = _k4_inputs(cuda, 48, 48, k, stride, hw, seed=k + stride)
        pad = wp.reshape(48, k * k, 64)
        assert not pad[:, :, 48:].any()
        g = torch.Generator(device=cuda).manual_seed(3)
        pad[:, :, 48:] = torch.randint(1, 128, (48, k * k, 16), device=cuda, generator=g,
                                       dtype=torch.int8)
        got = k4.int8_conv(x, wp, mult, bias, k, stride, out_scale=0.02)
        ref = k4.int8_conv_plain(x, wp, mult, bias, k, stride, out_scale=0.02)
        torch.cuda.synchronize()
        assert k4.route_of(48, 48, k, stride) == "wgmma"
        assert torch.equal(got, ref), (k, stride, (got.float() - ref.float()).abs().max())


@pytest.mark.parametrize("n,h,w,cin,cout,k,stride", _mma_shapes())
@pytest.mark.parametrize("mode", ["a", "a relu", "b", "c int8", "c f32"])
def test_int8_conv_mma_route_matches_plain(cuda, n, h, w, cin, cout, k, stride, mode):
    """The mma.sync route, which no zoo chain reaches, at the synthetic
    shapes chip_smoke.py times it at: Cout 8, 16, 24 and 96, 5x5 kernels,
    the flat layout, odd sizes; EXACT in every mode."""
    from lfdtpu_torch.ops import int8_conv as k4

    x, wp, mult, bias = _k4_inputs(cuda, cin, cout, k, stride, (h, w), seed=cout + k, batch=n)
    ho, wo = k4.out_hw(h, w, k, stride)
    kw = dict(relu="relu" in mode)
    if mode != "b":
        kw["out_scale"] = 0.02
    g = torch.Generator(device=cuda).manual_seed(4)
    if mode == "c int8":
        kw["residual"] = torch.randint(-127, 128, (n, ho, wo, cout), device=cuda,
                                       generator=g).to(torch.int8)
        kw["residual_scale"] = 0.013
    elif mode == "c f32":
        kw["residual"] = torch.randn(n, ho, wo, cout, device=cuda, generator=g)
    assert k4.route_of(cin, cout, k, stride) == "mma"
    before = dict(k4.int8_conv.routes)
    got = k4.int8_conv(x, wp, mult, bias, k, stride, **kw)
    ref = k4.int8_conv_plain(x, wp, mult, bias, k, stride, **kw)
    torch.cuda.synchronize()
    assert k4.int8_conv.routes == dict(before, mma=before["mma"] + 1)
    assert got.shape == ref.shape == (n, ho, wo, cout) and got.dtype == ref.dtype
    assert torch.equal(got, ref), (mode, (got.float() - ref.float()).abs().max())


def test_int8_conv_routes_by_shape(cuda):
    """Each K4_SHAPES conv reaches the route route_of names, and only it."""
    from lfdtpu_torch.ops import int8_conv as k4

    seen = set()
    for cin, cout, k, stride, hw in K4_SHAPES:
        x, wp, mult, bias = _k4_inputs(cuda, cin, cout, k, stride, hw, seed=0)
        before = dict(k4.int8_conv.routes)
        k4.int8_conv(x, wp, mult, bias, k, stride, out_scale=0.02)
        route = k4.route_of(cin, cout, k, stride)
        assert k4.int8_conv.routes == dict(before, **{route: before[route] + 1})
        seen.add(route)
    torch.cuda.synchronize()
    assert seen == set(k4.ROUTES)


def test_int8_conv_kernel_rejects_bad_input(cuda):
    from lfdtpu_torch.ops import int8_conv as k4

    x, wp, mult, bias = _k4_inputs(cuda, 64, 64, 3, 1, (8, 8), seed=0)
    with pytest.raises(ValueError, match="int8"):
        k4.int8_conv(x.float(), wp, mult, bias, 3, 1, out_scale=0.1)
    with pytest.raises(ValueError, match="shape"):
        k4.int8_conv(x, wp[:, :64].contiguous(), mult, bias, 3, 1, out_scale=0.1)
    with pytest.raises(ValueError, match="shape"):
        k4.int8_conv(x, wp, mult, bias, 3, 1, out_scale=0.1,
                     residual=torch.zeros(2, 4, 4, 64, dtype=torch.int8, device=cuda))


@pytest.mark.parametrize("size,head", [("S", None), ("L", "bf16")])
def test_captured_int8_engine_equals_eager(cuda, size, head):
    from lfdtpu_torch.deploy.int8_net import planned_launches

    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    det = _detector(size)
    engines = [compile_inference(det, ENGINE_HW, "int8", batch_size=2, int8_head_dtype=head,
                                 preprocess=make_device_preprocess((0.5,) * 3, (0.5,) * 3),
                                 captured=c) for c in (None, False)]
    assert engines[0].captured and not engines[1].captured
    assert engines[0].captured_launches == {
        "nms_mask_sorted": 1, "stem_conv": 0, "pair_conv3x3": 0,
        "int8_conv": planned_launches(det.net), "group_norm_relu": group_norm_calls(det.net)}
    vhw = np.asarray([[256, 320], [200, 311]], np.float32)
    for seed in (1, 2):
        f = _frames(seed)
        got, ref = engines[0](f, vhw), engines[1](f, vhw)
        assert int(got["count"].sum()) > 0 and _same(got, ref), (size, head, seed)


def test_int8_engine_on_the_card_matches_the_cpu(cuda):
    """One amax dict, the same weights: every int8 edge of the chain equal on
    the card and on the CPU (K4 against the plain version, constants folded on
    the CPU for both), the dense outputs within 1e-3 (the float head)."""
    from lfdtpu_torch.deploy import calibrate_module_amax, make_device_preprocess
    from lfdtpu_torch.deploy.int8_net import Int8Chain

    det = _detector("L")
    pre = make_device_preprocess((0.5,) * 3, (0.5,) * 3)
    f = _frames(3, 1)
    amax = calibrate_module_amax(det.net, [f], pre)
    x = pre(torch.as_tensor(f)).float()
    keys = {k[:-4]: None for k in amax if k.endswith("#out") and k != "__input__#out"}
    cap_cpu, cap_gpu = dict(keys), dict(keys)
    with torch.inference_mode():
        c_cpu, r_cpu = Int8Chain(det.net, amax)(x, capture=cap_cpu)
        gpu_net = det.net.to(cuda)
        c_gpu, r_gpu = Int8Chain(gpu_net, amax)(x.to(cuda), capture=cap_gpu)
        det.net.cpu()
    n8 = 0
    for k, v in cap_cpu.items():
        if isinstance(v, tuple):
            assert torch.equal(cap_gpu[k][0].cpu(), v[0]), k
            n8 += 1
    assert n8 == 17  # stem 2, blocks 10, neck 5: the GroupNorm head runs in float
    assert max_rel(c_gpu, c_cpu) < 1e-3 and max_rel(r_gpu, r_cpu) < 1e-3


# ------------------------------------------------- custom ops, engine files
# K1-K4 as torch.library ops on CUDA tensors (their CUDA kernels are the
# launches), and engines saved to a file and loaded on the card: captured as
# the built engine is, bit-equal to it, from uint8 and float frames.

def test_custom_ops_on_the_card(cuda):
    """opcheck on CUDA tensors: schema, fake tensor and dispatch to the
    kernels, each op's result equal to its wrapper's; the launch counters
    tick in the CUDA kernels."""
    g = torch.Generator().manual_seed(0)
    boxes = torch.rand(2, 200, 2, generator=g) * 100
    boxes = torch.cat([boxes, boxes + torch.rand(2, 200, 2, generator=g) * 30 + 1], -1)
    k1 = (boxes.to(cuda), (torch.rand(2, 200, generator=g) > 0.2).to(cuda), 0.4)
    frame = torch.randint(0, 256, (1, 64, 96, 3), dtype=torch.uint8, generator=g)
    k2 = (frame.to(cuda), torch.randn(3, 3, 3, 64, generator=g).to(cuda),
          torch.tensor([120.0, 110.0, 100.0], device=cuda),
          torch.tensor([60.0, 55.0, 70.0], device=cuda),
          (torch.rand(64, generator=g) + 0.5).to(cuda), torch.randn(64, generator=g).to(cuda),
          True)
    x = torch.randn(1, 32, 48, 64, generator=g).to(cuda, torch.bfloat16)
    k3 = (x, (torch.randn(3, 3, 64, 64, generator=g) * 0.05).to(cuda, torch.bfloat16),
          (torch.rand(64, generator=g) + 0.5).to(cuda), torch.randn(64, generator=g).to(cuda),
          x.clone(), True)
    from lfdtpu_torch.ops import int8_conv as k4

    q, _ = k4.quantize_weights(torch.randn(64, 64, 3, 3, generator=g))
    k4_args = (torch.randint(-127, 128, (1, 32, 48, 64), dtype=torch.int8,
                             generator=g).to(cuda), k4.pack_int8_weight(q).to(cuda),
               (torch.rand(64, generator=g) * 1e-3).to(cuda), torch.randn(64, generator=g).to(cuda),
               3, 1, True, 0.05, None, None)
    for op, args, counter in ((torch.ops.lfd.nms_mask_sorted, k1, nms_kernel.nms_mask_sorted),
                              (torch.ops.lfd.stem_conv, k2, conv_kernels.stem_conv),
                              (torch.ops.lfd.pair_conv3x3, k3, conv_kernels.pair_conv3x3),
                              (torch.ops.lfd.int8_conv, k4_args, k4.int8_conv)):
        torch.library.opcheck(op.default, args)
        before = counter.launches
        out = op(*args)
        assert counter.launches == before + 1
        assert torch.equal(out, counter(*args))
    ref = nms_kernel.nms_mask_sorted_plain(*k1)
    assert torch.equal(torch.ops.lfd.nms_mask_sorted_plain(*k1), ref)
    assert torch.equal(torch.ops.lfd.nms_mask_sorted(*k1), ref)


@pytest.mark.parametrize("variant", ["bf16_kernels", "int8"])
def test_loaded_engine_equals_the_built_one_on_the_card(cuda, variant, tmp_path,
                                                        monkeypatch):
    """An engine file loaded on the card is captured (one graph per frame
    dtype), launches what the built engine's capture launches, and returns
    its outputs bit for bit from uint8 frames, and from float frames where
    the engine takes them (the K2 engine refuses them), though the loading
    process has cuDNN's TF32 on: the engine runs under the switches it was
    built with (ROADMAP F18; the int8 engine's head is float32)."""
    from lfdtpu_torch.deploy import (compile_inference, load_engine, make_device_preprocess,
                                     save_engine)

    det = _detector("S")
    if variant == "int8":
        built = compile_inference(det, ENGINE_HW, "int8", batch_size=2,
                                  preprocess=make_device_preprocess((0.5,) * 3, (0.5,) * 3),
                                  classification_threshold=1e-4)
    else:
        built = _engine(det, variant, classification_threshold=1e-4)
    path = str(tmp_path / "e.lfde")
    save_engine(built, path)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's default
    loaded = load_engine(path)
    assert built.tf32 == loaded.tf32 == (False, False)
    assert loaded.captured and loaded.captured_launches == built.captured_launches
    vhw = np.asarray([[256, 320], [200, 311]], np.float32)
    u = _frames(21)
    assert int(built(u, vhw)["count"].sum()) > 0
    assert _same(loaded(u, vhw), built(u, vhw))
    assert _same(loaded(torch.as_tensor(u, device=cuda), torch.as_tensor(vhw, device=cuda)),
                 built(u, vhw))
    f = u.astype(np.float32) / 2
    if variant == "bf16_kernels":
        with pytest.raises(ValueError, match="uint8"):
            loaded(f, vhw)
    else:
        assert _same(loaded(f, vhw), built(f, vhw))
        assert set(loaded._graphs) == {torch.uint8, torch.float32}


# ------------------------------------------------------------ learning
# multiclass_nms through K1, and a trained synthetic LFD's int8 engine at
# 128x128, whose levels (K4's smallest tiles) no engine test above reaches.

def test_multiclass_nms_with_k1_equals_plain(cuda):
    from lfdtpu_torch.ops.nms import multiclass_nms

    rng = np.random.RandomState(9)
    B, K = 4, 1000
    xy = rng.rand(B, K, 2) * 12 * K ** 0.5
    boxes = np.concatenate([xy, xy + rng.rand(B, K, 2) * 60 + 1], -1)
    boxes += (rng.randint(0, 3, (B, K)) * (boxes.max() + 1.0))[..., None]
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=cuda)
    scores = torch.as_tensor(rng.randint(0, 21, (B, K)) / 20.0, dtype=torch.float32,
                             device=cuda)
    valid = torch.as_tensor(rng.rand(B, K) > 0.1, device=cuda)
    before = nms_kernel.nms_mask_sorted.launches
    keep, order, count = multiclass_nms(boxes, scores, 0.05, 0.5, max_num=100, valid=valid)
    torch.cuda.synchronize()
    assert nms_kernel.nms_mask_sorted.launches == before + 1
    pkeep, porder, pcount = multiclass_nms(boxes, scores, 0.05, 0.5, max_num=100, valid=valid,
                                           use_kernel=False)
    survivors = nms_mask(boxes, scores, 0.5, valid=valid & (scores > 0.05),
                         use_kernel=False).sum(-1)
    assert bool((survivors > 100).all())
    assert torch.equal(keep, pkeep) and torch.equal(count, pcount)
    for b, n in enumerate(survivors.tolist()):
        assert torch.equal(order[b, :n], porder[b, :n])


def test_trained_synthetic_lfd_int8_engine_k4_is_exact(cuda):
    """Two epochs of the synthetic LFD on the card, then its captured int8
    engine at 128x128 (calibrated on training frames): every K4 call of an
    eager pass over a val frame against the plain version, bit-equal."""
    from lfdtpu_torch.deploy import int8_net
    from lfdtpu_torch.ops import int8_conv as k4
    from lfdtpu_torch.tools import synthetic_e2e as syn

    val, _ = syn.make_dataset(1, seed=1)
    frame = torch.as_tensor(val[0]["image"][None], device=cuda)
    checked = []

    def on_engine(name, engine, score):
        calls, wrapper = [], int8_net.int8_conv

        def recorded(*args, **kwargs):
            calls.append((args, kwargs))
            return wrapper(*args, **kwargs)

        int8_net.int8_conv = recorded
        try:
            engine.dense(frame)
        finally:
            int8_net.int8_conv = wrapper
        assert engine.captured and len(calls) == int8_net.planned_launches(engine.net)
        for args, kwargs in calls:
            got, ref = k4.int8_conv(*args, **kwargs), k4.int8_conv_plain(*args, **kwargs)
            assert got.dtype == ref.dtype and torch.equal(got, ref), args[0].shape
        checked.append(len(calls))
        return score()

    m = syn.run_synthetic("lfd", epochs=2, threshold=-1.0, engine_quality=True,
                          precisions=("int8",), device="cuda", on_engine=on_engine)
    assert checked == [14] and 0.0 <= m["engine_mAP_50"]["int8"] <= 1.0


@pytest.mark.parametrize("variant", ["bf16_kernels", "int8"])
def test_one_rank_mesh_engine_equals_the_engine_without_a_mesh(cuda, variant):
    """compile_inference(mesh=make_mesh()) in a process group of one rank
    (NCCL) builds the engine of mesh=None, captured: the same launches per
    capture (K1-K3, or K1 and K4) and bit-equal rows."""
    import torch.distributed as dist

    from chip_smoke import free_port
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess
    from lfdtpu_torch.parallel import make_mesh

    det = _detector("L")
    kw = dict(ENGINE_VARIANTS.get(variant, dict(precision=variant)), batch_size=2,
              preprocess=make_device_preprocess((0.5,) * 3, (0.5,) * 3))
    plain = compile_inference(det, ENGINE_HW, **kw)
    if variant == "int8":
        kw["act_scales"] = plain.int8_chain.amax
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        meshed = compile_inference(det, ENGINE_HW, mesh=mesh, **kw)
        assert meshed.captured and meshed.mesh is None and mesh.device.type == "cuda"
        assert meshed.captured_launches == plain.captured_launches
        vhw = np.asarray([[256, 320], [200, 311]], np.float32)
        for seed in (1, 2):
            f = _frames(seed)
            ref = plain(f, vhw)
            assert int(ref["count"].sum()) > 0 and _same(meshed(f, vhw), ref)
    finally:
        dist.destroy_process_group()


def test_captured_engine_spans_time_the_replay_on_the_device(cuda):
    """The predict API over a captured engine under a profiler session:
    engine.stage, engine.replay and engine.clone inside each predict call,
    the replay's device time from its events above 0 and within the
    call's host time."""
    from torch.profiler import ProfilerActivity, profile

    from lfdtpu_torch import tracing

    det = _detector("L")
    engine = _engine(det, "bf16_kernels")  # a fresh capture: one profiler session replays it
    frames = list(_frames(4, batch=4))
    det.predict_for_batch_with_engine(engine, frames[:2])
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            det.predict_for_batch_with_engine(engine, frames[i:i + 2])
    spans = tracing.summary()["spans"]
    calls = [s for s in tracing._RECORDER.spans if s.name == "predict"]
    assert len(calls) == 3
    for c in calls:
        kids = sorted(s.name for s in tracing._RECORDER.spans if s.parent == c.id)
        assert kids == ["engine.clone", "engine.replay", "engine.stage", "predict.fetch",
                        "predict.pad", "predict.rows"]
    replay = spans["engine.replay"]
    assert replay["calls"] == 3 and 0 < replay["stream_ms"] < spans["predict"]["host_ms"]
    assert spans["engine.stage"]["stream_ms"] is None
    assert {"predict", "engine.replay"} <= {e.name for e in prof.events()}
    tracing.reset()


def test_captured_engine_stages_unpadded_frames_in_one_pass(cuda):
    """The predict API over a captured engine, frames of three extents in
    turn and then the first again: its rows equal those of a captured
    engine fed the same frames pre-padded; `engine.stage_bytes` reads the
    frame's bytes plus the stale pad zeroed, and the frame's bytes alone
    once an extent repeats; the synchronous loop reuses one pinned slot.
    Then a burst of calls with no sync between them: each result equals the
    pre-padded one, and the graph keeps at most STAGING_SLOTS slots."""
    from torch.profiler import ProfilerActivity, profile

    from lfdtpu_torch import tracing
    from lfdtpu_torch.deploy.runner import STAGING_SLOTS
    from lfdtpu_torch.ops.decode import detections_to_lists

    det = _detector("L")
    engine = _engine(det, "bf16_kernels", batch_size=1)
    padded_engine = _engine(det, "bf16_kernels", batch_size=1)
    H, W = ENGINE_HW
    extents = [(200, 311), (H, 160), (130, W), (200, 311), (200, 311)]
    frames = [_frames(20 + i, 1, hw)[0] for i, hw in enumerate(extents)]

    def padded(frame):
        out = np.zeros((1, H, W, 3), np.uint8)
        out[0, :frame.shape[0], :frame.shape[1]] = frame
        return out

    def rows_of(out):
        out = {k: v.cpu().numpy() for k, v in out.items()}
        return detections_to_lists({k: v[0] for k, v in out.items()})

    vhw = [np.asarray(f.shape[:2], np.float32) for f in frames]
    refs = [rows_of(padded_engine(padded(f), v)) for f, v in zip(frames, vhw)]
    g = engine._graphs[torch.uint8]
    last, hosts, total = (0, 0), None, 0
    tracing.reset()
    # one CPU-only session: a captured graph is never replayed under two (F16)
    with profile(activities=[ProfilerActivity.CPU]):
        for (h, w), frame, ref in zip(extents, frames, refs):
            rows = det.predict_for_single_image_with_engine(engine, frame)
            staged = tracing._RECORDER.counters["engine.stage_bytes"] - total
            total += staged
            assert rows == ref, (h, w)
            stale = last[0] * last[1] - min(last[0], h) * min(last[1], w)
            assert staged == 3 * (h * w + stale), (h, w, staged)
            if (h, w) == last:
                assert staged == 3 * h * w
            last = (h, w)
            ptrs = [s.host.data_ptr() for s in g.slots]
            assert hosts is None or ptrs == hosts  # no new buffer per call
            hosts = ptrs
    assert tracing.summary()["counters"]["engine.stage_bytes"] == total
    assert len(g.slots) == 1
    tracing.reset()

    want = [padded_engine(padded(f), v) for f, v in zip(frames, vhw)]
    got = []
    for _ in range(3):
        got += [engine([f], v) for f, v in zip(frames, vhw)]
        assert len(g.slots) <= STAGING_SLOTS
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want * 3))
    assert sum(int(w["count"].sum()) for w in want) > 0


def test_no_span_records_inside_a_graph_capture(cuda):
    from torch.profiler import ProfilerActivity, profile

    from lfdtpu_torch import tracing

    x = torch.ones(1024, device=cuda)
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            with tracing.span("captured", cuda) as s:
                y = x * 2
        assert s.seq is None
        graph.replay()
        with tracing.span("replayed", cuda):
            graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, x * 2)
    spans = tracing.summary()["spans"]
    assert "captured" not in spans and spans["replayed"]["stream_ms"] > 0
    tracing.reset()


# K5 (csrc/group_norm.cu) against F.group_norm then relu in float32 at
# chip_smoke.K5_SHAPES: the five WIDERFACE-L head levels at 1088x1920,
# TT100K-L's 512x512 level, a batch of 2, FCOS's 256 channels in 32 groups
# (FCOS-R50-FPN's 112x176 P3 and 7x11 P7 at 896x1408 among them), in
# bf16 (the served engines) and float32 (the int8 engine's head). bf16: the
# output's one rounding (at most 2^-8 of a value) bounds the gap; float32,
# the statistics' summation order.
K5_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def _k5_inputs(cuda, n, h, w, c, dtype, seed=0, **kw):
    from chip_smoke import k5_inputs

    return k5_inputs(cuda, torch.Generator(device=cuda).manual_seed(seed), n, h, w, c, dtype,
                     **kw)


def _k5_reference(x, gamma, beta, groups, dtype=torch.float32):
    """relu(F.group_norm) in `dtype`, NHWC in and out."""
    xr = x.to(dtype).permute(0, 3, 1, 2).contiguous()
    y = torch.nn.functional.group_norm(xr, groups, gamma.to(dtype), beta.to(dtype), 1e-5)
    return torch.relu(y).permute(0, 2, 3, 1)


def _k5_shapes():
    from chip_smoke import K5_SHAPES

    return K5_SHAPES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,w,c,groups", _k5_shapes())
def test_group_norm_kernel_matches_plain(cuda, dtype, n, h, w, c, groups):
    x, gamma, beta = _k5_inputs(cuda, n, h, w, c, dtype)
    before = group_norm.group_norm_relu.launches
    got = group_norm.group_norm_relu(x, gamma, beta, groups, 1e-5)
    assert group_norm.group_norm_relu.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    assert max_rel(got, _k5_reference(x, gamma, beta, groups)) <= K5_TOL[dtype]


@pytest.mark.parametrize("dtype,offset,spread,tol", [
    (torch.float32, 1000.0, 0.05, 1e-3), (torch.bfloat16, 256.0, 4.0, 2.0 ** -7)])
def test_group_norm_module_keeps_a_large_mean_offset(cuda, dtype, offset, spread, tol):
    """A channels_last NCHW map far from zero through the engine's module:
    E[x^2] - E[x]^2 would cancel (at mean 1000 and std 0.05 float32 keeps
    no digit of the variance); the kernel's merged moments hold it to the
    float64 computation."""
    from lfdtpu_torch.deploy.kernel_net import FusedGroupNormReLU

    x, gamma, beta = _k5_inputs(cuda, 1, 68, 120, 128, dtype, offset=offset, spread=spread)
    norm = torch.nn.GroupNorm(16, 128).to(cuda)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
    module = FusedGroupNormReLU(norm.to(dtype))
    xc = x.permute(0, 3, 1, 2)  # channels_last NCHW, as the engine's net holds it
    assert xc.is_contiguous(memory_format=torch.channels_last)
    got = module(xc)
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = _k5_reference(x.cpu(), module.weight.cpu(), module.bias.cpu(), 16, torch.float64)
    assert max_rel(got.permute(0, 2, 3, 1), ref) <= tol


def test_group_norm_kernel_is_deterministic_and_replays(cuda):
    """Two calls are bit-equal (the partials merge in a fixed order), and a
    captured graph's replay (the programmatic dependent launch included)
    gives the eager call's result."""
    x, gamma, beta = _k5_inputs(cuda, 1, 272, 480, 128, torch.bfloat16, seed=3)
    a = group_norm.group_norm_relu(x, gamma, beta, 16, 1e-5)
    b = group_norm.group_norm_relu(x, gamma, beta, 16, 1e-5)
    assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        group_norm.group_norm_relu(x, gamma, beta, 16, 1e-5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = group_norm.group_norm_relu(x, gamma, beta, 16, 1e-5)
    x.copy_(_k5_inputs(cuda, 1, 272, 480, 128, torch.bfloat16, seed=4)[0])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, group_norm.group_norm_relu(x, gamma, beta, 16, 1e-5))
    torch.library.opcheck(torch.ops.lfd.group_norm_relu.default, (x, gamma, beta, 16, 1e-5))


def test_group_norm_kernel_rejects_bad_input(cuda):
    x, gamma, beta = _k5_inputs(cuda, 1, 8, 8, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="groups"):
        group_norm.group_norm_relu(x, gamma, beta, 32, 1e-5)  # 4 channels a group
    with pytest.raises(ValueError, match="groups"):
        group_norm.group_norm_relu(x.half(), gamma, beta, 16, 1e-5)
    with pytest.raises(ValueError, match="float32"):
        group_norm.group_norm_relu(x, gamma.bfloat16(), beta, 16, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        group_norm.group_norm_relu(x.transpose(1, 2), gamma, beta, 16, 1e-5)


K5_UNPAIRED = 0.05  # share of an image's rows above the cut left without a twin


def _rows(out, i):
    k = int(out["count"][i])
    return (out["boxes"][i, :k].float().cpu(), out["scores"][i, :k].float().cpu(),
            out["labels"][i, :k].cpu())


def _unpaired(a, b, px=1.0, score=0.02):
    """Rows of `a` with no row of `b` of the same label within px and score."""
    (ba, sa, la), (bb, sb, lb) = a, b
    if not len(sb):
        return sa
    near = (((ba[:, None] - bb[None]).abs().amax(-1) <= px)
            & ((sa[:, None] - sb[None]).abs() <= score) & (la[:, None] == lb[None]))
    return sa[~near.any(1)]


@pytest.mark.parametrize("name", ["widerface-L", "tt100k-L"])
def test_k5_engine_serves_the_aten_engines_rows(cuda, monkeypatch, name):
    """A captured bf16 K1-K3 engine with K5 against the same engine with its
    GroupNorms left to ATen: dense outputs within 2^-4 of their largest (two
    bf16 nets that round at other places: chip_smoke's SPATIAL_DENSE_TOL),
    and every served row paired within 1 px and 0.02 of score but rows at
    the score cut and at most K5_UNPAIRED of the rest (a box that moves
    across the NMS threshold keeps or drops a row: TT100K's 45 classes meet
    it more often); the engine's counter gives K5's launches per call under
    a profiler session."""
    from torch.profiler import ProfilerActivity, profile

    from lfdtpu_torch import tracing
    from lfdtpu_torch.deploy import kernel_net

    from chip_smoke import CLS_STD

    det = (_detector("L") if name == "widerface-L" else
           _detector(None, name="TT100K-L", cls_std=CLS_STD))
    want = group_norm_calls(det.net)
    assert want == (10 if name == "widerface-L" else 16)
    k5 = _engine(det, "bf16_kernels")
    assert k5.captured_launches["group_norm_relu"] == want
    with monkeypatch.context() as m:
        m.setattr(kernel_net, "_eligible_pairs", lambda net: [])
        aten = _engine(det, "bf16_kernels")
    assert aten.captured_launches["group_norm_relu"] == 0
    vhw = np.asarray([[256, 320], [200, 311]], np.float32)
    for seed in (1, 2):
        f = _frames(seed)
        for dk, da in zip(k5.dense(f), aten.dense(f)):
            assert max_rel(dk, da) < 2.0 ** -4, (name, seed)
        got, ref = k5(f, vhw), aten(f, vhw)
        for i in range(2):
            a, b = _rows(got, i), _rows(ref, i)
            assert len(b[1]) > 0
            cut = min(float(a[1].min()), float(b[1].min())) + 0.02
            for x, y in ((a, b), (b, a)):
                above = [float(s) for s in _unpaired(x, y) if s > cut]
                assert len(above) <= K5_UNPAIRED * len(x[1]), (name, seed, i, cut, above)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in (3, 4, 5):
            det.predict_for_batch_with_engine(k5, list(_frames(seed)))
    assert tracing.summary()["counters"]["engine.gn_kernel"] == 3 * want
    tracing.reset()


def test_captured_bf16_fcos_engine_serves_the_eager_bf16_nets_rows(cuda):
    """FCOS-R50-FPN (chip_smoke.fcos_r50_fpn, the zoo's recipe) as a captured
    bf16 engine: K5 on the towers' 8 pairs at 5 levels (40 launches) and K1
    in the graph, the centerness in its decode. Against the eager bf16 net
    (ATen's GroupNorm, the eager decode): dense outputs within 2^-4 of their
    largest (the regression's logits, before the head's exp, which turns a
    logit's rounding into as large a share of the distance) and rows paired
    as the K5-engine test pairs them (F23); the
    counters give K5's launches and the candidates that entered NMS."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from lfdtpu_torch import tracing
    from lfdtpu_torch.deploy import compile_inference
    from lfdtpu_torch.models.detector import eval_forward

    from chip_smoke import fcos_r50_fpn

    det = fcos_r50_fpn(cuda, seed=3)
    det16 = copy.copy(det)
    det16.net = copy.deepcopy(det.net).to(torch.bfloat16)
    hw = (256, 384)
    engine = compile_inference(det, hw, "bf16")  # raw pixels, as the eager nets here
    assert engine.captured and engine.captured_launches == {
        "nms_mask_sorted": 1, "stem_conv": 0, "pair_conv3x3": 0, "int8_conv": 0,
        "group_norm_relu": 40}
    frames = _frames(7, 3, hw)
    x = torch.as_tensor(frames[:1], device=cuda)
    for k, (dk, de) in enumerate(zip(engine.dense(frames[:1]), eval_forward(det16.net, x))):
        if k == 1:  # the head's exp of the regression: compare the logits, as for LFD
            dk, de = dk.log(), de.log()
        assert max_rel(dk, de) < 2.0 ** -4, k
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for f in frames:
            got = det.predict_for_single_image_with_engine(engine, f[:250, :380])
            ref = det16.predict_for_single_image(f[:250, :380])
            assert len(got) > 0 and len(ref) > 0
            for a, b in ((got, ref), (ref, got)):
                a, b = (torch.tensor(r)[:, [2, 3, 4, 5, 1, 0]] for r in (a, b))
                a = (a[:, :4], a[:, 4], a[:, 5].long())
                b = (b[:, :4], b[:, 4], b[:, 5].long())
                cut = min(float(a[1].min()), float(b[1].min())) + 0.02
                above = [float(s) for s in _unpaired(a, b) if s > cut]
                assert len(above) <= K5_UNPAIRED * len(a[1]), (cut, above)
    counters = tracing.summary()["counters"]
    tracing.reset()
    assert counters["engine.gn_kernel"] == 3 * 40
    assert 0 < counters["engine.nms_candidates"] <= 3 * det.decode_spec().nms_budget


# K6 (csrc/assign.cu) against the plain lfd_assign on the same card, bit for
# bit (torch.equal): the same float32 operations in the same order, each
# correctly rounded on both sides (the CPU's plain version takes MKL's
# square root, which can differ in the last place: so the card's).
def _k6_levels(cuda, hw, strides=(4, 8, 16, 32, 64), ranges=None):
    from lfdtpu_torch import zoo
    from lfdtpu_torch.ops import points as point_ops

    ranges = ranges or zoo.WIDERFACE_SCALES
    sizes = point_ops.feature_map_sizes_for_input(hw, strides)
    gray = point_ops.compute_gray_ranges(ranges, (0.9, 1.1))
    info = point_ops.concat_level_info(sizes, strides, ranges, gray)
    return tuple(torch.as_tensor(info[k], device=cuda)
                 for k in ("points", "strides", "ranges", "gray_ranges"))


def _k6_cell_batch(cuda, seed, n=64, nmax=200, num_classes=1, shuffle=False):
    """n images of wfl-train-480's seeded ground truth (benchmark/traffic/
    train_480.json's draw at 480x480); shuffle: each image's rows in a random
    order, so that real rows lie in every 128-row tile K6 stages."""
    import json
    from pathlib import Path

    from benchmark.loops.train import ground_truth

    spec = json.loads((Path(__file__).parents[1] / "benchmark/traffic/train_480.json")
                      .read_text())["boxes"]
    rng = np.random.default_rng([seed, 3])
    gt, labels, mask = ground_truth(rng, n, (480, 480), nmax, num_classes, spec)
    if shuffle:
        for i in range(n):
            order = rng.permutation(nmax)
            gt[i], labels[i], mask[i] = gt[i, order], labels[i, order], mask[i, order]
    return tuple(torch.as_tensor(a, device=cuda) for a in (gt, labels, mask))


def _k6_check(levels, gt, labels, mask, num_classes, mode="dist", normalize=False):
    """K6 once (one launch) against the plain version on the same tensors."""
    from lfdtpu_torch.ops import assign

    args = (*levels, gt, labels, mask, num_classes, mode, normalize)
    before = assign.lfd_assign.launches
    got = assign.lfd_assign(*args)
    assert assign.lfd_assign.launches == before + 1
    want = assign.lfd_assign_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, w), int((g != w).sum())
    return got


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_assign_kernel_matches_plain_on_the_cells_batches(cuda, seed):
    levels = _k6_levels(cuda, (480, 480))
    assert levels[0].shape[0] == 19189
    for k in range(2):
        gt, labels, mask = _k6_cell_batch(cuda, seed + k)
        cls, reg = _k6_check(levels, gt, labels, mask, 1)
        assert (cls < 0).any() and (cls > 0).any() and (reg != 0).any()
        assert (~mask.any(1)).any()  # images with no boxes (20% of the draw)


@pytest.mark.parametrize("num_classes", [1, 45])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", ["longer", "shorter", "sqrt", "dist"])
def test_assign_kernel_matches_plain_in_every_mode(cuda, mode, normalize, num_classes):
    levels = _k6_levels(cuda, (480, 480))
    gt, labels, mask = _k6_cell_batch(cuda, 7, n=8, nmax=300, num_classes=num_classes,
                                      shuffle=True)
    assert mask[:, 128:].any() and mask[:, 256:].any()
    cls, _ = _k6_check(levels, gt, labels, mask, num_classes, mode, normalize)
    assert (cls > 0).any() and (cls < 0).any()


# the CPU tests' levels: 64x64 at strides 4, 8, 16
SMALL_RANGES = ((0, 16), (16, 32), (32, 64))


def _k6_case(case):
    """(gt (B, N, 4), labels (B, N), mask (B, N), C, mode, {point: what K6
    must give there}) of one hand-made case at 64x64."""
    gt = np.zeros((3, 4, 4), np.float32)
    labels = np.zeros((3, 4), np.int64)
    mask = np.zeros((3, 4), bool)
    p16 = 4 * 16 + 4  # the stride-4 point (16, 16)
    if case == "no boxes, all masked":
        gt[0::2, :2] = [[8, 8, 12, 12], [20, 20, 30, 30]]
        mask[0, :2] = True  # image 1 has no boxes, image 2 only masked ones
        return gt, labels, mask, 1, "dist", {}
    if case in ("tied, first wins", "tied, reversed"):
        # one centre, both in level 1's sqrt range: equal scores everywhere
        pair = np.array([[12, 12, 17, 17], [8, 8, 25, 25]], np.float32)
        gt[0, :2] = pair if case == "tied, first wins" else pair[::-1]
        mask[0, :2] = True
        x, y, w, h = gt[0, 0]
        p = 16 * 16 + 2 * 8 + 2  # the stride-8 point (16, 16)
        return gt, labels, mask, 1, "sqrt", {p: [16 - x, 16 - y, x + w - 1 - 16, y + h - 1 - 16]}
    if case in ("gray before green", "green before gray"):
        green, gray = [10, 10, 10, 10], [8, 8, 17, 17]  # 10 in (0, 16]; 17 in (16, 17.6]
        gt[0, :2] = [gray, green] if case == "gray before green" else [green, gray]
        mask[0, :2] = True
        return gt, labels, mask, 1, "longer", {p16: -1.0}
    if case == "label outside [0, C)":
        gt[0, :3] = [[8, 8, 12, 12], [20, 20, 30, 30], [4, 30, 20, 20]]
        labels[0, :3] = [7, -1, 1]
        mask[0, :3] = True
        return gt, labels, mask, 2, "dist", {}
    if case == "on the image edge":
        # inclusive extents: (8, 8, 9, 9) ends at 16, so the point (16, 16)
        # is a hit; the second box spans the whole image
        gt[0, :2] = [[8, 8, 9, 9], [0, 0, 64, 64]]
        mask[0, :2] = True
        return gt, labels, mask, 1, "longer", {p16: "hit"}
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "no boxes, all masked", "tied, first wins", "tied, reversed", "gray before green",
    "green before gray", "label outside [0, C)", "on the image edge"])
def test_assign_kernel_hard_cases(cuda, case):
    gt, labels, mask, C, mode, want = _k6_case(case)
    levels = _k6_levels(cuda, (64, 64), (4, 8, 16), SMALL_RANGES)
    cls, reg = _k6_check(levels, *(torch.as_tensor(a, device=cuda) for a in (gt, labels, mask)),
                         C, mode)
    cls, reg = cls.cpu(), reg.cpu()
    if case == "no boxes, all masked":
        assert (cls[1:] == 0).all() and (reg[1:] == 0).all() and (cls[0] > 0).any()
    if case == "label outside [0, C)":
        assert (cls[0, :, 0] == 0).all() and (cls[0, :, 1] > 0).any() and (reg[0] != 0).any()
    for p, v in want.items():
        if v == "hit":
            assert cls[0, p, 0] > 0
        elif isinstance(v, float):
            assert cls[0, p, 0] == v
        else:
            assert reg[0, p].tolist() == v and cls[0, p, 0] > 0


def test_assign_kernel_rejects_what_it_does_not_take(cuda):
    from lfdtpu_torch.ops import assign

    levels = _k6_levels(cuda, (64, 64), (4, 8, 16), SMALL_RANGES)
    gt, labels, mask, *_ = _k6_case("label outside [0, C)")
    gt, labels, mask = (torch.as_tensor(a, device=cuda) for a in (gt, labels, mask))
    with pytest.raises(ValueError, match="float32"):  # no float64 training on the card
        assign.lfd_assign(*(t.double() for t in levels), gt.double(), labels, mask, 2)
    with pytest.raises(ValueError, match="float32"):
        assign.lfd_assign(*levels, gt.double(), labels, mask, 2)
    with pytest.raises(ValueError, match="classes"):
        assign.lfd_assign(*levels, gt, labels, mask, assign.MAX_CLASSES + 1)
    with pytest.raises(ValueError, match="mode"):
        assign.lfd_assign(*levels, gt, labels, mask, 2, "area")
    with pytest.raises(ValueError, match="integer"):
        assign.lfd_assign(*levels, gt, labels.float(), mask, 2)
    with pytest.raises(ValueError, match="contiguous"):
        assign.lfd_assign(*levels, gt.transpose(0, 1).contiguous().transpose(0, 1), labels,
                          mask, 2)
    with pytest.raises(ValueError, match="expected a tensor on"):
        assign.lfd_assign(*levels, gt, labels, mask.cpu(), 2)
    # int32 labels are taken (widened); C up to the limit; an empty batch
    # launches nothing (the plain version takes no empty batch)
    _k6_check(levels, gt, labels.int(), mask, assign.MAX_CLASSES)
    before = assign.lfd_assign.launches
    cls, reg = assign.lfd_assign(*levels, gt[:0], labels[:0], mask[:0], 2)
    assert cls.shape == (0, 336, 2) and reg.shape == (0, 336, 4)
    assert assign.lfd_assign.launches == before  # a count of launches, not of calls
    torch.library.opcheck(torch.ops.lfd.lfd_assign.default,
                          (*levels, gt, labels, mask, 2, "dist", True))
