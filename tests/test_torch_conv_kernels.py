# K2 (fused uint8 stem) and K3 (3x3 64->64 conv + fused epilogue): the
# port's plain versions against lfdtpu's Pallas kernels in interpret mode,
# with the tolerances of tests/test_conv_pallas.py (max-relative 0.02 for the
# pair conv, 0.03 for the stem: bf16 inputs/outputs, different rounding
# points). Also the engine-side packing (BGR fold, BN fold, block routing)
# and the CPU dispatch of the wrappers. The CUDA kernels against their plain
# versions run on the card.
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lfdtpu.deploy.compile import cast_variables as jax_cast
from lfdtpu.deploy.pallas_net import prepack_stem as jax_prepack_stem
from lfdtpu.ops.conv_pallas import pack_pair_weights, pair_conv3x3 as jax_pair_conv
from lfdtpu.ops.conv_pallas import pack_stem, stem_conv as jax_stem_conv
from lfdtpu_torch.deploy import compile_inference, make_device_preprocess
from lfdtpu_torch.ops import conv_kernels

from tests.test_torch_bridge import jax_and_port

torch.set_num_threads(1)


def max_rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


@pytest.mark.parametrize("hw,residual", [((32, 16), True), ((24, 8), True),
                                         ((16, 12), False)])
def test_pair_conv_plain_matches_pallas(hw, residual):
    h, w = hw
    rng = np.random.RandomState(h)
    x = rng.randn(2, h, w, 64).astype(np.float32) * 0.5
    k = rng.randn(3, 3, 64, 64).astype(np.float32) * 0.1
    scale = rng.rand(64).astype(np.float32) + 0.5
    bias = rng.randn(64).astype(np.float32) * 0.1
    res = rng.randn(2, h, w, 64).astype(np.float32) * 0.5
    xb = jnp.asarray(x, jnp.bfloat16)
    resb = jnp.asarray(res, jnp.bfloat16)

    wp = jnp.asarray(pack_pair_weights(k), jnp.bfloat16)
    sb = jnp.asarray(np.stack([np.tile(scale, 2), np.tile(bias, 2)]))
    with pltpu.force_tpu_interpret_mode():
        ref = [jax_pair_conv(xb[n], wp, sb, residual=resb[n] if residual else None,
                             relu=residual) for n in range(2)]

    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    tres = torch.from_numpy(np.array(resb.astype(jnp.float32))).bfloat16()
    got = conv_kernels.pair_conv3x3(
        tx, torch.from_numpy(k).bfloat16(), torch.from_numpy(scale),
        torch.from_numpy(bias), residual=tres if residual else None, relu=residual)
    assert got.dtype == torch.bfloat16 and got.shape == (2, h, w, 64)
    for n in range(2):
        assert max_rel(got[n].float().numpy(), ref[n]) < 0.02


@pytest.mark.parametrize("hw", [(16, 24), (24, 16)])
def test_stem_plain_matches_pallas(hw):
    h, w = hw
    rng = np.random.RandomState(2)
    frame = rng.randint(0, 255, (2, h, w, 3)).astype(np.uint8)
    k = rng.randn(3, 3, 3, 64).astype(np.float32) * 0.1
    mean = np.array([120.0, 115.0, 110.0], np.float32)
    std = np.array([60.0, 58.0, 62.0], np.float32)
    scale = rng.rand(64).astype(np.float32) + 0.5
    bias = rng.randn(64).astype(np.float32) * 0.1

    wq, affine, out_sb = pack_stem(k, mean, std, scale=scale, bias=bias)
    with pltpu.force_tpu_interpret_mode():
        ref = [jax_stem_conv(jnp.asarray(frame[n]), wq, affine, out_sb, relu=True)
               for n in range(2)]
    got = conv_kernels.stem_conv(
        torch.from_numpy(frame), torch.from_numpy(k), torch.from_numpy(mean),
        torch.from_numpy(std), torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.shape == (2, h // 2, w // 2, 64)
    for n in range(2):
        assert max_rel(got[n].float().numpy(), ref[n]) < 0.03


def test_stem_plain_odd_size_keeps_torch_padding():
    # no H % 8 / W % 4 limit: ceil(H/2) x ceil(W/2) outputs, as torch pads
    rng = np.random.RandomState(5)
    frame = torch.from_numpy(rng.randint(0, 255, (1, 13, 22, 3)).astype(np.uint8))
    w = torch.from_numpy(rng.randn(3, 3, 3, 64).astype(np.float32) * 0.1)
    ones, zeros = torch.ones(64), torch.zeros(64)
    got = conv_kernels.stem_conv(frame, w, torch.zeros(3), torch.ones(3), ones, zeros)
    assert got.shape == (1, 7, 11, 64)


def test_prepack_stem_folds_bgr_and_bn_like_lfdtpu():
    """The engine's stem pack (bf16-cast weights, BN folded in fp32, BGR flip
    folded into weights and mean/std) against lfdtpu's prepack_stem + the
    Pallas stem in interpret mode, on a real WIDERFACE-L stem."""
    jdet, variables, tdet = jax_and_port("WIDERFACE-L")
    mean, std = (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)
    frame = np.random.RandomState(6).randint(0, 255, (1, 32, 48, 3)).astype(np.uint8)

    jpre = jax_prepack_stem(jax_cast(variables, jnp.bfloat16),
                            np.float32(mean) * 255, np.float32(std) * 255,
                            bgr2rgb=True)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_stem_conv(jnp.asarray(frame[0]), *jpre, relu=True)

    pre = make_device_preprocess(mean, std, bgr2rgb=True)
    engine = compile_inference(tdet, (32, 48), "bf16", preprocess=pre,
                               kernel_stem=True, device="cpu")
    pack = engine.net._backbone.fused_stem.pack
    got = conv_kernels.stem_conv(torch.from_numpy(frame), *pack)
    assert max_rel(got[0].float().numpy(), ref) < 0.03


def test_tl_stem_folds_bgr2rgb_imagenet_like_lfdtpu():
    """TL-L's engine stem: BGR -> RGB and the imagenet mean/std (not the same
    in each channel, so a constant swapped with the flip shows) folded into
    K2's constants, against lfdtpu's prepack_stem and the Pallas stem in
    interpret mode."""
    jdet, variables, tdet = jax_and_port("TL-L")
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    frame = np.random.RandomState(8).randint(0, 255, (1, 32, 48, 3)).astype(np.uint8)
    jpre = jax_prepack_stem(jax_cast(variables, jnp.bfloat16),
                            np.float32(mean) * 255, np.float32(std) * 255, bgr2rgb=True)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_stem_conv(jnp.asarray(frame[0]), *jpre, relu=True)
    engine = compile_inference(tdet, (32, 48), "bf16",
                               preprocess=make_device_preprocess(mean, std, bgr2rgb=True),
                               kernel_stem=True, device="cpu")
    pack = engine.net._backbone.fused_stem.pack
    got = conv_kernels.stem_conv(torch.from_numpy(frame), *pack)
    assert max_rel(got[0].float().numpy(), ref) < 0.03
    # without the fold, the same frame gives another stem output
    plain = make_device_preprocess(mean, std)
    unswapped = compile_inference(tdet, (32, 48), "bf16", preprocess=plain, kernel_stem=True,
                                  device="cpu").net._backbone.fused_stem.pack
    assert max_rel(conv_kernels.stem_conv(torch.from_numpy(frame), *unswapped)[0]
                   .float().numpy(), ref) > 0.03


@pytest.mark.parametrize("name,blocks", [("TT100K-L", 6), ("TL-L", 6), ("TL-S", 1),
                                         ("TT100K-S", 4)])
def test_traffic_block_routing(name, blocks):
    # the 64-channel stride-1 FasterBlocks of each zoo plan, two K3 launches each
    _, _, tdet = jax_and_port(name)
    net = compile_inference(tdet, (64, 64), "bf16", kernel_convs=True, device="cpu").net
    assert len([m for m in net.modules() if getattr(m, "fused", None)]) == blocks


def test_block_routing_matches_lfdtpu_eligibility():
    _, _, tdet = jax_and_port("WIDERFACE-L")
    net = compile_inference(tdet, (64, 64), "bf16", kernel_convs=True, device="cpu").net
    routed = [n for n, m in net.named_modules() if getattr(m, "fused", None)]
    # stage0 blocks 1-3, stage1 block 1, stage2 block 1 (the 64-channel
    # stride-1 FasterBlocks); stages 3-4 are 128 channels
    assert routed == ["_backbone.stage0.1", "_backbone.stage0.2",
                      "_backbone.stage0.3", "_backbone.stage1.1",
                      "_backbone.stage2.1"]
    # fp32 engines leave every conv on F.conv2d, as lfdtpu leaves fp32 on XLA
    net32 = compile_inference(tdet, (64, 64), "fp32", kernel_convs=True, device="cpu").net
    assert not [m for m in net32.modules() if getattr(m, "fused", None)]


def test_fused_block_matches_module_block():
    """One fused FasterBlock (two K3 plain calls, BN folded in fp32) against
    the same block's layers in fp32 on the bf16-cast weights."""
    _, _, tdet = jax_and_port("WIDERFACE-L")
    net = compile_inference(tdet, (64, 64), "bf16", kernel_convs=True, device="cpu").net
    block = net._backbone.stage0[1]
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 64, 16, 20)
                         .astype(np.float32)).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        got = block.fused(x).float()
        block.fused = None
        ref = block.float()(x.float())
    assert max_rel(got.numpy(), ref.numpy()) < 0.02


def test_kernel_stem_rejects_ineligible_nets():
    _, _, tdet = jax_and_port("WIDERFACE-XS")  # 32-channel stem0
    pre = make_device_preprocess((0.5,) * 3, (0.5,) * 3)
    with pytest.raises(ValueError, match="stem0"):
        compile_inference(tdet, (64, 64), "bf16", preprocess=pre, kernel_stem=True,
                          device="cpu")
    _, _, tdet = jax_and_port("TL-S")  # 48-channel stem0: TL-S engines keep the plain stem
    with pytest.raises(ValueError, match="stem0"):
        compile_inference(tdet, (64, 64), "bf16", preprocess=pre, kernel_stem=True,
                          device="cpu")
    _, _, tdet = jax_and_port("WIDERFACE-L")
    with pytest.raises(ValueError, match="bf16"):
        compile_inference(tdet, (64, 64), "fp32", preprocess=pre, kernel_stem=True,
                          device="cpu")


def test_cpu_wrappers_do_not_launch():
    before = (conv_kernels.stem_conv.launches, conv_kernels.pair_conv3x3.launches)
    x = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16)
    conv_kernels.pair_conv3x3(x, w, torch.ones(64), torch.zeros(64))
    conv_kernels.stem_conv(torch.zeros(1, 8, 8, 3, dtype=torch.uint8),
                           torch.zeros(3, 3, 3, 64), torch.zeros(3), torch.ones(3),
                           torch.ones(64), torch.zeros(64))
    assert (conv_kernels.stem_conv.launches,
            conv_kernels.pair_conv3x3.launches) == before
