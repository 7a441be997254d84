# The K3 dispatch over a whole net (lfdtpu_torch/deploy/kernel_net.py), the
# port of tests/test_pallas_net.py's two tests, on the CPU, where K3's
# wrapper runs its plain version:
#   - WIDERFACE-L in bf16 at 64x64 with the dispatch on equals the plain net
#     within 0.02 of the output's max (the JAX test's tolerance: bf16
#     rounding order only, the folded BN runs in fp32), and lfdtpu's
#     interpret-mode interception on the same weights and input within 0.05
#     of the output's max (two frameworks round bf16 at different places:
#     tests/test_torch_engine.py holds the bf16 engines to the same 0.05);
#   - WIDERFACE-S in train() with fp32 input calls no kernel wrapper at all
#     and updates its BN statistics (ROADMAP F14: the dispatch is for eval
#     mode and bf16 input only).
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from lfdtpu.deploy.compile import cast_variables as jax_cast
from lfdtpu.deploy.pallas_net import pallas_conv_interception, prepack_pair_weights
from lfdtpu_torch.deploy import cast_variables, kernel_net
from tests.test_torch_bridge import jax_and_port

torch.set_num_threads(1)


def _count_wrapper_calls(monkeypatch):
    """Count every call of K2's and K3's wrappers from the dispatch (their
    own launch counters tick on the card only)."""
    calls = {"pair_conv3x3": 0, "stem_conv": 0}
    for name in calls:
        real = getattr(kernel_net, name)

        def counted(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(kernel_net, name, counted)
    return calls


def _max_rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3))


def test_block_dispatch_matches_plain_net_and_lfdtpu_interception(monkeypatch):
    jdet, variables, tdet = jax_and_port("WIDERFACE-L")
    x = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32) * 2 - 1
    xt = torch.as_tensor(x).bfloat16()

    plain = cast_variables(tdet.net, torch.bfloat16).to(memory_format=torch.channels_last).eval()
    fused = cast_variables(tdet.net, torch.bfloat16).to(memory_format=torch.channels_last).eval()
    n_blocks = kernel_net.attach_kernels(fused, block_kernels=True)
    assert n_blocks > 0, "expected eligible 3x3 64->64 FasterBlocks in WIDERFACE-L"
    calls = _count_wrapper_calls(monkeypatch)
    with torch.inference_mode():
        c0, r0 = plain(xt)
        assert calls["pair_conv3x3"] == 0
        c1, r1 = fused(xt)
    assert calls == {"pair_conv3x3": 2 * n_blocks, "stem_conv": 0}
    assert _max_rel(c1.float(), c0.float()) <= 0.02
    assert _max_rel(r1.float(), r0.float()) <= 0.02

    rv = jax_cast(variables, jnp.bfloat16)
    packs = prepack_pair_weights(rv)
    assert len(packs) >= 2 * n_blocks  # every 64 -> 64 3x3 conv is packed, eligible or not
    with pltpu.force_tpu_interpret_mode():
        with pallas_conv_interception(packs):
            jc, jr = jdet.net.apply(rv, jnp.asarray(x, jnp.bfloat16), train=False)
    assert _max_rel(c1.float(), jc) <= 0.05
    assert _max_rel(r1.float(), jr) <= 0.05


def test_dispatch_falls_through_in_train_mode_and_for_fp32(monkeypatch):
    _, _, tdet = jax_and_port("WIDERFACE-S")
    net = cast_variables(tdet.net, torch.float32).to(memory_format=torch.channels_last)
    n_blocks = kernel_net.attach_kernels(net, block_kernels=True)
    assert n_blocks > 0
    assert all(m.fused is not None for m in net.modules()
               if kernel_net.eligible_faster_block(m))
    calls = _count_wrapper_calls(monkeypatch)
    x = torch.as_tensor(np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32))

    net.train()
    before = {k: v.clone() for k, v in net.state_dict().items() if "running_" in k}
    outs = net(x)  # train mode and fp32: the layers run, with batch statistics
    assert outs[0].shape[0] == 2 and outs[0].dtype == torch.float32
    assert calls == {"pair_conv3x3": 0, "stem_conv": 0}
    after = net.state_dict()
    assert before and all(not torch.equal(v, after[k]) for k, v in before.items())

    net.eval()
    with torch.inference_mode():
        net(x)  # eval mode but fp32 input: still the layers
        assert calls["pair_conv3x3"] == 0
        net.bfloat16().train()
        net(x.bfloat16())  # bf16 input but train mode: still the layers
        assert calls["pair_conv3x3"] == 0
        net.eval()
        net(x.bfloat16())  # eval mode and bf16: K3's wrapper, twice per block
    assert calls["pair_conv3x3"] == 2 * n_blocks
