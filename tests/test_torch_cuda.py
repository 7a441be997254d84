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


# ---------------------------------------------------------------- engines
# The captured (CUDA-graph) engine against the eager engine of the same
# build, on the card: the same kernels in the same order on the same inputs,
# so every output tensor must be bit-equal.

ENGINE_HW = (256, 320)
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


@pytest.mark.parametrize("variant", list(ENGINE_VARIANTS))
@pytest.mark.parametrize("size", ["S", "L"])
def test_captured_engine_rows_equal_eager(cuda, size, variant):
    det = _detector(size)
    captured = _engine(det, variant)  # the default on the card
    eager = _engine(det, variant, captured=False)
    assert captured.captured and not eager.captured
    k3 = 10  # five eligible FasterBlocks in S and in L, two launches each
    assert captured.captured_launches == {
        "nms_mask_sorted": int(variant != "bf16_plain"),
        "stem_conv": int(variant == "bf16_kernels"),
        "pair_conv3x3": k3 * int(variant == "bf16_kernels")}
    vhw = np.asarray([[256, 320], [200, 311]], np.float32)
    before = nms_kernel.nms_mask_sorted.launches
    for seed in (1, 2):
        f = _frames(seed)
        got = captured(f, vhw)
        ref = eager(f, vhw)
        assert int(got["count"].sum()) > 0
        assert _same(got, ref), (size, variant, seed)
        # a frame and extents already on the card take the other input path
        again = captured(torch.as_tensor(f, device=cuda), torch.as_tensor(vhw, device=cuda))
        assert _same(again, ref)
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
    with pytest.raises(ValueError, match="uint8"):
        engine(_frames(1).astype(np.float32), ENGINE_HW)
    with pytest.raises(ValueError, match="uint8"):
        engine(torch.zeros(2, *ENGINE_HW, 3, device=cuda), ENGINE_HW)
    assert int(engine(_frames(1), ENGINE_HW)["count"].sum()) > 0  # still serves


def test_a_capture_that_cannot_succeed_raises(cuda, monkeypatch):
    """A host sync inside what is captured: compile_inference raises, hands
    back no engine, and the next capture works."""
    from lfdtpu_torch.deploy import compile as compile_mod

    det = _detector("S")
    real = compile_mod.Engine._decode
    state = {"calls": 0}

    def syncing(self, cls_o, reg_o, vhw):
        state["calls"] += 1
        if torch.cuda.is_current_stream_capturing():
            cls_o.sum().item()  # a host sync: not permitted in a capture
        return real(self, cls_o, reg_o, vhw)

    monkeypatch.setattr(compile_mod.Engine, "_decode", syncing)
    with pytest.raises(RuntimeError, match="capturing the engine"):
        _engine(det, "bf16_kernels")
    assert state["calls"] > 1  # the warmup calls ran eagerly before the capture
    assert _engine(det, "bf16_kernels", captured=False).captured is False  # eager on request
    monkeypatch.setattr(compile_mod.Engine, "_decode", real)
    engine = _engine(det, "bf16_kernels")
    f = _frames(11)
    assert engine.captured
    assert _same(engine(f, ENGINE_HW), _engine(det, "bf16_kernels", captured=False)(f, ENGINE_HW))


def test_timing_inference_on_the_card(cuda):
    from lfdtpu_torch.deploy import timing_inference

    engine = _engine(_detector("S"), "bf16_kernels", batch_size=1)
    r = timing_inference(engine, _frames(12, 1), ENGINE_HW, warmup_loops=3, timing_loops=10)
    assert r["method"] == "cuda_events_per_call" and r["loops"] == 10
    assert 0 < r["ms_min"] <= r["ms_per_image"] <= r["ms_p95"]


# ------------------------------------------------------- traffic and LFDv2
# The TT100K, TrafficLight and LFDv2 paths on the card: K3 at TT100K's
# 2048x2048 levels, K2 with TL's BGR -> RGB and imagenet constants folded in,
# K1 behind 45 class offsets, and their captured engines against eager ones.

@pytest.mark.parametrize("n,hw", [(1, (512, 512)), (4, (512, 512)), (4, (256, 256)),
                                  (4, (128, 128))])
@pytest.mark.parametrize("residual", [True, False])
def test_pair_conv_kernel_matches_plain_at_tt100k_shapes(cuda, n, hw, residual):
    x, w, s, b = _k3_inputs(cuda, n, hw, hw[0] + n)
    res = x.roll(1, 0).contiguous() if residual else None
    got = conv_kernels.pair_conv3x3(x, w, s, b, residual=res, relu=True)
    ref = conv_kernels.pair_conv3x3_plain(x, w, s, b, residual=res, relu=True)
    torch.cuda.synchronize()
    assert max_rel(got, ref) < 0.02


@pytest.mark.parametrize("n,hw", [(1, (768, 1280)), (4, (768, 1280)), (1, (2048, 2048))])
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
