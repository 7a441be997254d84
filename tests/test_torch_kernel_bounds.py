# chip_smoke.kernel_bound_ms against bounds worked out by hand from the
# engine's shapes (NVIDIA's H100 SXM data sheet: 3.35 TB/s, 989 TFLOP/s
# dense bf16, 1,979 TOP/s dense int8, 67 TFLOP/s fp32), and the entry points'
# device default: an omitted device is the card, and without one they raise
# instead of quietly running on the CPU.
import pytest
import torch

import chip_smoke
from lfdtpu_torch import zoo
from lfdtpu_torch.deploy import compile_inference
from lfdtpu_torch.execution import SGD
from lfdtpu_torch.parallel import create_train_state

torch.set_num_threads(1)

ACT = 272 * 480 * 64 * 2              # one bf16 NHWC activation at the first level
K3_CONSTS = 9 * 64 * 64 * 2 + 2 * 64 * 4  # bf16 weights, fp32 scale and bias


@pytest.mark.parametrize("name,shape,residual,nbytes,us", [
    # in, residual, out: 50.1 MB, 14.97 us (14.99 with the 74 KB of weights)
    ("pair_conv3x3", (1, 272, 480), True, 3 * ACT + K3_CONSTS, 14.97),
    ("pair_conv3x3", (1, 272, 480), False, 2 * ACT + K3_CONSTS, 9.98),
    # 6.3 MB of uint8 in, 66.8 MB of bf16 out
    ("stem_conv", (1, 1088, 1920), False,
     1088 * 1920 * 3 + 544 * 960 * 64 * 2 + 27 * 64 * 4 + 6 * 4 + 2 * 64 * 4, 21.8),
    # K6 at the train cell's batch 64, 480x480 (19,189 points), C 1, 200 GT
    # rows with 823 real: 24.6 MB of float32 targets out; 7 floats a point,
    # the mask and the real rows' xywh and int64 label in; its 126 M fp32
    # hit-test operations (8 a pair) take 1.89 us, under the bytes
    ("lfd_assign", (64, 19189, 1, 200, 823), False,
     64 * 19189 * 5 * 4 + 19189 * 7 * 4 + 64 * 200 + 823 * 24, 7.50),
])
def test_kernel_bound_is_bytes_bound_at_engine_shapes(name, shape, residual, nbytes, us):
    ms, by = chip_smoke.kernel_bound_ms(name, shape, residual)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert ms * 1e3 == pytest.approx(us, abs=0.03)


def test_kernel_bound_counts_operations_where_they_bind():
    # K3's 9.63 GFLOP at 272x480 take 9.73 us at the bf16 peak, under its bytes
    nbytes, flops, kind = chip_smoke.kernel_work("pair_conv3x3", (1, 272, 480), True)
    assert (flops, kind) == (2 * 272 * 480 * 64 * 576, "bf16")
    assert flops / 989e12 < nbytes / 3.35e12
    # K1 at K = 1000: 499,500 box pairs of 14 fp32 operations, 18 KB of bytes
    ms, by = chip_smoke.kernel_bound_ms("nms_mask_sorted", (1, 1000))
    assert by == "operations"
    assert ms == pytest.approx(499500 * 14 / 67e12 * 1e3, rel=1e-12)
    assert ms < 1e-3
    with pytest.raises(ValueError, match="unknown kernel"):
        chip_smoke.kernel_bound_ms("conv", (1, 2, 3))


def test_int8_conv_bound_by_hand():
    # K4, stage 0's 3x3 64 -> 64 at 272x480: 8.36 MB of int8 in and out, 36.9
    # KB of int8 weights, 512 B of fp32 mult and bias: 5.00 us at 3.35 TB/s,
    # over its 9.63 G int8 operations at 1,979 TOP/s (4.86 us)
    shape = (1, 272, 480, 64, 64, 3, 1, "a")
    act = 272 * 480 * 64
    nbytes, ops, kind = chip_smoke.kernel_work("int8_conv", shape)
    assert nbytes == 2 * act + 9 * 64 * 64 + 2 * 64 * 4
    assert (ops, kind) == (2 * 272 * 480 * 64 * 576, "int8")
    ms, by = chip_smoke.kernel_bound_ms("int8_conv", shape)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert ms * 1e3 == pytest.approx(5.00, abs=0.01)
    assert ops / 1979e12 * 1e6 == pytest.approx(4.86, abs=0.01)
    # its int8 residual adds one more int8 activation, the shortcut's f32
    # output (mode b) four bytes an element: a 1x1/s2 64 -> 128 at 272x480,
    # which reads only the 136x240 pixels it samples
    res = chip_smoke.kernel_work("int8_conv", (1, 272, 480, 64, 64, 3, 1, "c8"))[0]
    assert res == nbytes + act
    sc = chip_smoke.kernel_work("int8_conv", (1, 272, 480, 64, 128, 1, 2, "b"))[0]
    assert sc == 136 * 240 * 64 + 128 * 64 + 2 * 128 * 4 + 136 * 240 * 128 * 4
    # s0.0's shortcut at 544x960: 8.4 MB in (not the whole 33.4 MB), 33.4 MB
    # of f32 out, 12.5 us
    ms, by = chip_smoke.kernel_bound_ms("int8_conv", (1, 544, 960, 64, 64, 1, 2, "b"))
    assert by == "bytes" and ms * 1e3 == pytest.approx(12.47, abs=0.01)
    # stem0 at 1088x1920: 6.3 MB in, 33.4 MB out
    stem = chip_smoke.kernel_work("int8_conv", (1, 1088, 1920, 3, 64, 3, 2, "a"))[0]
    assert stem == 1088 * 1920 * 3 + 64 * 27 + 512 + 544 * 960 * 64


def test_k3_shapes_are_the_engine_levels():
    assert chip_smoke.k3_shapes() == ((272, 480), (136, 240), (68, 120))


@pytest.fixture(scope="module")
def detector():
    det = zoo.widerface_lfd("XS")
    det.init(torch.Generator().manual_seed(0))
    return det


def test_compile_inference_defaults_to_the_card(detector):
    if torch.cuda.is_available():
        assert compile_inference(detector, (64, 64)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            compile_inference(detector, (64, 64))
    engine = compile_inference(detector, (64, 64), device="cpu")
    assert engine.device == torch.device("cpu")
    assert next(engine.net.parameters()).device.type == "cpu"


def test_create_train_state_defaults_to_the_card(detector):
    if torch.cuda.is_available():
        state = create_train_state(detector, SGD(momentum=0.9))
        assert next(state.net.parameters()).device.type == "cuda"
        detector.net.cpu()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_train_state(detector, SGD(momentum=0.9))
    state = create_train_state(detector, SGD(momentum=0.9), device="cpu")
    assert next(state.net.parameters()).device.type == "cpu"
    assert state.net.training

