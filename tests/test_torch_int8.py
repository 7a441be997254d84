# The port's int8 engine (lfdtpu_torch/deploy/{quantize,int8_net}.py,
# ops/int8_conv.py, compile_inference(precision="int8")) against lfdtpu's, on
# the CPU, on seeded numpy inputs and bridged weights with randomized BN
# statistics. On the CPU, K4's wrapper runs its plain version. lfdtpu's
# int8_fused_apply runs unjitted (eager), as its per-op float32 rounding is
# what the port mirrors; its engines run jitted, as users build them.
#
# Tolerances, each with its cause:
#   - quantize_net_int8 / quantize_weights, the calibrator cache, K4's plain
#     version against lfdtpu's _cna_int8 on the same folded constants: equal,
#     bit for bit (the same float32 and bf16 operations, one at a time);
#   - folded_norm against lfdtpu's _folded_norm: the scale within 2 ulp
#     (FOLD_ULPS), since XLA's CPU rsqrt is not correctly rounded and torch's
#     differs from it by 1 ulp in about a third of the values, which the
#     product with the BN weight can carry to 2;
#   - calibrate_module_amax: rel 1e-5 (two float32 nets sum in different
#     orders);
#   - every int8 edge of the chain, one amax dict: equal, or off by 1 LSB on at
#     most 0.1% of an edge's elements (EDGE_FRAC): a 1-ulp rsqrt difference in
#     a folded BN scale can move a requant that lies on a rounding boundary,
#     and the next convs carry it on;
#   - dense outputs and engine rows: within 1e-4 relative (the float GroupNorm
#     head sums in another order), bf16 heads within bf16 rounding.
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lfdtpu.deploy import Int8Calibrator as JaxCalibrator
from lfdtpu.deploy import compile_inference as jax_compile
from lfdtpu.deploy import make_device_preprocess as jax_preprocess
from lfdtpu.deploy import quantize_variables_int8
from lfdtpu.deploy.compile import cast_variables as jax_cast
from lfdtpu.deploy.int8_net import _cna_int8, _folded_norm, _quantize_to, _quantize_weights
from lfdtpu.deploy.int8_net import calibrate_module_amax as jax_calibrate
from lfdtpu.deploy.int8_net import int8_fused_apply as jax_fused_apply
from lfdtpu_torch.deploy import (Int8Calibrator, Int8Chain, calibrate_module_amax,
                                 compile_inference, int8_fused_apply, make_device_preprocess,
                                 quantize_net_int8)
from lfdtpu_torch.deploy.int8_net import folded_norm, planned_launches
from lfdtpu_torch.execution.jax_convert import jax_amax_to_port, jax_variables_to_state_dict
from lfdtpu_torch.ops import int8_conv as k4
from tests.test_torch_bridge import jax_and_port, randomize_norms

torch.set_num_threads(1)

MEAN, STD = (0.45, 0.5, 0.55), (0.25, 0.25, 0.3)
EDGE_FRAC = 1e-3
FOLD_ULPS = 2
DENSE_TOL = 1e-4


def _frames(seed, b=1, hw=(64, 64)):
    return np.random.RandomState(seed).randint(0, 255, (b,) + hw + (3,)).astype(np.uint8)


def _tiny_pair(seed=0):
    """lfdtpu's tests/test_detector.py::tiny_lfd and the port's twin with the
    same (bridged) weights: a 'fastest' stem of 8 and 16 channels, two
    FastestBlocks, a GroupNorm merge head."""
    from tests.test_detector import tiny_lfd
    from lfdtpu_torch.models import LFD, LFDHead, LFDResNet, SimpleNeck
    from lfdtpu_torch.ops.loss_wrappers import FocalLoss, IoULoss

    jdet = tiny_lfd()
    variables = randomize_norms(jdet.init(jax.random.PRNGKey(seed), (64, 64)), seed)
    bn = dict(type="BatchNorm2d")
    bb = LFDResNet(block_mode="fastest", stem_mode="fastest", body_mode=None,
                   stem_channels=16, body_architecture=(1, 1), body_channels=(16, 32),
                   out_indices=((0, 0), (1, 0)), norm_cfg=bn)
    strides = tuple(bb.num_output_strides_list)
    neck = SimpleNeck(bb.num_output_channels_list, 32, strides, norm_cfg=bn)
    head = LFDHead(1, 2, 32, num_head_channels=32, num_conv_layers=1,
                   norm_cfg=dict(type="GroupNorm", num_groups=8), share_head_flag=True,
                   merge_path_flag=True)
    tdet = LFD(backbone=bb, neck=neck, head=head, num_classes=1,
               regression_ranges=((0, 32), (32, 64)), point_strides=strides,
               classification_loss_func=FocalLoss(), regression_loss_func=IoULoss(),
               distance_to_bbox_mode="sigmoid")
    tdet.net.load_state_dict(jax_variables_to_state_dict(variables, tdet.net), strict=True)
    tdet.net.eval()
    return jdet, variables, tdet


def _state_equal(variables, net):
    """A JAX variables tree equals a port net's state, bit for bit."""
    ref = jax_variables_to_state_dict(variables, net)
    got = net.state_dict()
    for k, v in ref.items():
        a, b = torch.as_tensor(np.asarray(v, np.float32)), got[k].float()
        assert torch.equal(a, b), k


# ------------------------------------------------------------ fake-quant

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_net_int8_equals_lfdtpus(dtype):
    _, variables, tdet = jax_and_port("WIDERFACE-S")
    jv = variables if dtype == "fp32" else jax_cast(variables, jnp.bfloat16)
    net = tdet.net if dtype == "fp32" else copy.deepcopy(tdet.net).to(torch.bfloat16)
    ref = jax.device_get(quantize_variables_int8(jv))
    got = quantize_net_int8(net)
    _state_equal(ref, got)
    w0 = got._backbone._stem[0].weight
    assert w0.dtype == net._backbone._stem[0].weight.dtype
    assert not torch.equal(w0, net._backbone._stem[0].weight)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,k", [(3, 64, 3), (64, 64, 3), (64, 64, 1), (48, 48, 3),
                                        (32, 32, 3), (128, 128, 1), (64, 128, 1)])
def test_quantize_weights_equals_lfdtpus(dtype, cin, cout, k):
    rng = np.random.RandomState(cin + cout + k)
    w = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)  # HWIO
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, js = _quantize_weights(jnp.asarray(w, jdt))
    tq, ts = k4.quantize_weights(torch.as_tensor(w).permute(3, 2, 0, 1).to(dtype))
    assert ts.dtype == dtype
    assert np.array_equal(np.asarray(jq), tq.permute(2, 3, 1, 0).numpy())
    assert np.array_equal(np.asarray(js, np.float32), ts.float().numpy())
    # K4's packing keeps every weight: unpack(pack(q)) == q
    assert torch.equal(k4.unpack_int8_weight(k4.pack_int8_weight(tq), cin, k), tq)


def test_int8_calibrator_cache_is_read_across_packages(tmp_path):
    for writer, reader in ((Int8Calibrator, JaxCalibrator), (JaxCalibrator, Int8Calibrator)):
        cache = str(tmp_path / f"{writer.__module__}.npy")
        c = writer(cache)
        assert not c.has_cache()
        c.update(np.full((1, 4, 4, 3), -7.25, np.float32))
        c.update(np.full((1, 2, 2, 3), 3.0, np.float32))
        c.save()
        r = reader(cache)
        assert r.has_cache() and r.input_amax == 7.25


# ------------------------------------------------------------ calibration

@pytest.mark.parametrize("name", ["WIDERFACE-L", "TL-S", "WIDERFACE-XS"])
def test_calibrate_module_amax_matches_lfdtpus(name):
    jdet, variables, tdet = jax_and_port(name)
    frames = [_frames(1, 2), _frames(2, 2)]
    ref = jax_calibrate(jdet, variables, frames, preprocess=jax_preprocess(MEAN, STD))
    got = calibrate_module_amax(tdet, frames, preprocess=make_device_preprocess(MEAN, STD))
    mapped = jax_amax_to_port(ref, tdet.net)
    assert set(mapped) == set(got)  # the map places every key, and covers the port's
    for k, v in got.items():
        assert v == pytest.approx(mapped[k], rel=1e-5), k
    # every key the chain reads is there: a plan from it launches K4 for every unit
    assert len(Int8Chain(tdet.net, mapped).units) == planned_launches(tdet.net)


@pytest.mark.parametrize("name", ["WIDERFACE-L", "TL-S", "WIDERFACE-XS"])
def test_calibration_walk_is_the_nets_forward(name):
    """calibrate_module_amax reads the net along the chain's structure: that
    walk computes net(x) exactly, so it records what the net computes."""
    from lfdtpu_torch.deploy.int8_net import _float_walk, net_structure

    _, _, tdet = jax_and_port(name)
    x = make_device_preprocess(MEAN, STD)(torch.as_tensor(_frames(4, 2))).float()
    with torch.inference_mode():
        walked = _float_walk(net_structure(tdet.net), x, lambda k, t: None)
        ref = tdet.net(x)
    assert all(torch.equal(a, b) for a, b in zip(walked, ref))


def test_amax_map_raises_on_a_key_it_cannot_place():
    _, _, tdet = jax_and_port("WIDERFACE-L")
    for key in ("backbone/stem9#out", "backbone/stage7_block0#in", "neck/neck5#out",
                "head/shared_merge/conv2#out", "backbone/stem0", "somewhere/else#in"):
        with pytest.raises(KeyError):
            jax_amax_to_port({key: 1.0}, tdet.net)


# ------------------------------------------------------------ K4's plain version

def _tree(rng, k, cin, cout, norm):
    kernel = (rng.randn(k, k, cin, cout) * (2.0 / (k * k * cin)) ** 0.5).astype(np.float32)
    if norm:
        tree = {"Conv_0": {"kernel": kernel},
                "Norm_0": {"BatchNorm_0": {
                    "scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                    "bias": (rng.randn(cout) * 0.1).astype(np.float32)}}}
        stats = {"Norm_0": {"BatchNorm_0": {
            "mean": rng.uniform(-0.5, 0.5, cout).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}}}
    else:
        tree = {"Conv_0": {"kernel": kernel, "bias": (rng.randn(cout) * 0.1).astype(np.float32)}}
        stats = {}
    return tree, stats


ZOO_CONVS = [(3, 64, 3, 2), (3, 48, 3, 2), (3, 32, 3, 2), (64, 64, 1, 1), (64, 64, 3, 1),
             (64, 64, 3, 2), (64, 64, 1, 2), (64, 128, 3, 2), (64, 128, 1, 2),
             (128, 128, 3, 1), (128, 128, 1, 1), (64, 128, 1, 1), (48, 48, 3, 1),
             (48, 64, 3, 2), (32, 32, 3, 1), (32, 64, 1, 1), (128, 128, 3, 2)]


@pytest.mark.parametrize("cin,cout,k,stride", ZOO_CONVS)
def test_k4_plain_equals_lfdtpus_cna_int8(cin, cout, k, stride):
    """Every kernel size, stride, Cin and Cout of the zoo's int8 chain, every
    output mode: (a) int8 with and without ReLU, (b) float32, (c) int8 with
    an int8 residual and with a float32 one. Both sides get lfdtpu's folded
    constants, so the arithmetic alone is compared: bit for bit."""
    rng = np.random.RandomState(cin * 7 + cout + k * 3 + stride)
    h, w = 13, 18
    x8 = rng.randint(-127, 128, (2, h, w, cin)).astype(np.int8)
    s_in, s_out, s_x = 0.0213, 0.0371, 0.0177
    ho, wo = k4.out_hw(h, w, k, stride)
    for norm in (True, False):
        tree, stats = _tree(rng, k, cin, cout, norm)
        nscale, nbias = (np.array(v) for v in _folded_norm(tree, stats))
        wq, w_scale = k4.quantize_weights(torch.as_tensor(tree["Conv_0"]["kernel"])
                                          .permute(3, 2, 0, 1))
        mult = (torch.tensor(np.float32(s_in)) * w_scale) * torch.as_tensor(nscale)
        args = (torch.as_tensor(x8), k4.pack_int8_weight(wq), mult, torch.as_tensor(nbias),
                k, stride)

        def jcna(relu, out_scale):
            return np.asarray(_cna_int8(tree, stats, None, jnp.asarray(x8), s_in,
                                        kernel_size=k, stride=stride, relu=relu,
                                        out_scale=out_scale))

        for relu in (True, False):  # (a)
            got = k4.int8_conv(*args, relu=relu, out_scale=s_out)
            assert got.dtype == torch.int8
            assert np.array_equal(got.numpy(), jcna(relu, s_out)), (norm, relu)
        f = jcna(False, None)  # (b)
        assert np.array_equal(k4.int8_conv(*args).numpy(), f)
        r8 = rng.randint(-127, 128, (2, ho, wo, cout)).astype(np.int8)  # (c), int8
        ident = jnp.asarray(r8).astype(jnp.float32) * s_x
        want = _quantize_to(jnp.maximum(jnp.asarray(f) + ident, 0.0), s_out)
        got = k4.int8_conv(*args, out_scale=s_out, residual=torch.as_tensor(r8),
                           residual_scale=s_x)
        assert np.array_equal(got.numpy(), np.asarray(want))
        rf = (rng.randn(2, ho, wo, cout) * 0.5).astype(np.float32)  # (c), float32
        want = _quantize_to(jnp.maximum(jnp.asarray(f) + jnp.asarray(rf), 0.0), s_out)
        got = k4.int8_conv(*args, out_scale=s_out, residual=torch.as_tensor(rf))
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_folded_norm_within_an_ulp_of_lfdtpus():
    """The only float difference of the chain's constants: XLA's CPU rsqrt
    against torch's (1 ulp), times the BN weight."""
    rng = np.random.RandomState(5)
    tree, stats = _tree(rng, 3, 64, 64, True)
    jscale, jbias = (np.asarray(v) for v in _folded_norm(tree, stats))
    conv = torch.nn.Conv2d(64, 64, 3, padding=1, bias=False)
    norm = torch.nn.BatchNorm2d(64)
    bn, st = tree["Norm_0"]["BatchNorm_0"], stats["Norm_0"]["BatchNorm_0"]
    with torch.no_grad():
        norm.weight.copy_(torch.as_tensor(bn["scale"]))
        norm.bias.copy_(torch.as_tensor(bn["bias"]))
        norm.running_mean.copy_(torch.as_tensor(st["mean"]))
        norm.running_var.copy_(torch.as_tensor(st["var"]))
    scale, bias = (v.numpy() for v in folded_norm(conv, norm))
    assert np.all(np.abs(scale - jscale) <= FOLD_ULPS * np.spacing(np.abs(jscale)))
    assert np.allclose(bias, jbias, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ the chain

def _count_k4_calls(monkeypatch):
    """Count the chain's calls of K4's wrapper on the CPU, where it runs the
    plain version (its launch counter ticks on the card only)."""
    calls = [0]
    plain = k4.int8_conv_plain

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(k4, "int8_conv_plain", counted)
    return calls

def _compare_edges(jcap, tcap, tnet):
    """Every captured edge: int8 equal up to EDGE_FRAC of 1-LSB moves, float
    within DENSE_TOL. Returns the number of int8 edges."""
    n8 = 0
    for jkey, a in jcap.items():
        name = next(iter(jax_amax_to_port({jkey + "#out": 1.0}, tnet)))[:-4]
        b = tcap[name]
        assert a is not None and b is not None, jkey
        a = np.asarray(a)
        if isinstance(b, tuple):
            assert a.dtype == np.int8, jkey
            d = np.abs(a.astype(np.int32) - b[0].numpy().astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= EDGE_FRAC, (jkey, d.max(), (d > 0).mean())
            n8 += 1
        else:
            b = b.float().permute(0, 2, 3, 1).numpy()
            assert np.abs(a - b).max() <= DENSE_TOL * np.abs(a).max(), jkey
    return n8


@pytest.mark.parametrize("name,n8", [("WIDERFACE-L", 17), ("TL-S", 18), ("WIDERFACE-XS", 20)])
def test_chain_edges_match_lfdtpus(name, n8, monkeypatch):
    """One amax dict for both (lfdtpu's, mapped), every module edge captured:
    the stem units, the blocks, the neck and the head's merge units (int8 in
    TL's norm-free head, float in WIDERFACE's GroupNorm head), then the dense
    outputs."""
    jdet, variables, tdet = jax_and_port(name)
    frames = _frames(3, 2)
    amax = jax_calibrate(jdet, variables, [frames], preprocess=jax_preprocess(MEAN, STD))
    x = np.asarray(jax_preprocess(MEAN, STD)(jnp.asarray(frames)), np.float32)
    jcap = {k[:-4]: None for k in amax
            if k.endswith("#out") and k != "__input__#out" and "/ConvNormAct_" not in k
            and "/_Shortcut_" not in k}
    jc, jr = jax_fused_apply(jdet.net, variables, jnp.asarray(x), amax, capture=jcap)
    mapped = jax_amax_to_port(amax, tdet.net)
    tcap = {next(iter(jax_amax_to_port({k + "#out": 1.0}, tdet.net)))[:-4]: None for k in jcap}
    calls = _count_k4_calls(monkeypatch)
    with torch.inference_mode():
        tc, tr = int8_fused_apply(tdet.net, torch.as_tensor(x), mapped, capture=tcap)
    assert calls[0] == planned_launches(tdet.net)
    assert _compare_edges(jcap, tcap, tdet.net) == n8
    for t, j in ((tc, jc), (tr, jr)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= DENSE_TOL * np.abs(j).max()


def test_planned_launches_count_the_units():
    # WIDERFACE-L: stem 2, blocks (4, 2, 2, 1, 1) x 2 convs + 5 shortcuts, neck
    # 5; TL-L's norm-free head adds its 2 merge units at each of 5 levels
    assert planned_launches(jax_and_port("WIDERFACE-L")[2].net) == 32
    assert planned_launches(jax_and_port("TL-L")[2].net) == 2 + 2 * 14 + 5 + 5 + 10


# ------------------------------------------------------------ engines

def _engines(name, head=None, **kw):
    jdet, variables, tdet = jax_and_port(name)
    frames = [_frames(7, 2), _frames(8, 2)]
    amax = jax_calibrate(jdet, variables, frames, preprocess=jax_preprocess(MEAN, STD))
    common = dict(batch_size=2, classification_threshold=0.01, int8_head_dtype=head, **kw)
    je = jax_compile(jdet, variables, (64, 64), "int8", act_scales=amax,
                     preprocess=jax_preprocess(MEAN, STD), **common)
    te = compile_inference(tdet, (64, 64), "int8", act_scales=jax_amax_to_port(amax, tdet.net),
                           preprocess=make_device_preprocess(MEAN, STD), device="cpu", **common)
    return je, te


@pytest.mark.parametrize("name", ["WIDERFACE-L", "TL-S", "WIDERFACE-XS"])
def test_int8_engine_rows_match_lfdtpus(name):
    je, te = _engines(name, class_agnostic=name == "TL-S")
    imgs = _frames(9, 2)
    vhw = np.asarray([[64, 64], [50, 41]], np.float32)
    ref = {k: np.asarray(v) for k, v in je(jnp.asarray(imgs), jnp.asarray(vhw)).items()}
    got = {k: v.numpy() for k, v in te(imgs, vhw).items()}
    assert ref["count"].sum() > 0
    np.testing.assert_array_equal(got["count"], ref["count"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=DENSE_TOL, atol=1e-6)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=DENSE_TOL, atol=1e-3)


def test_int8_bf16_head_engine_matches_lfdtpus():
    """int8_head_dtype="bf16": both quantize from bf16 weights and run the
    GroupNorm head in bf16; scores within bf16 rounding of each other."""
    je, te = _engines("WIDERFACE-L", head="bf16")
    imgs = _frames(10, 2)
    vhw = np.asarray([64, 64], np.float32)
    ref = {k: np.asarray(v) for k, v in je(jnp.asarray(imgs), jnp.asarray(vhw)).items()}
    got = {k: v.numpy() for k, v in te(imgs, vhw).items()}
    for b in range(2):
        na, nb = int(ref["count"][b]), int(got["count"][b])
        assert na > 0 and abs(na - nb) <= 1, (na, nb)
        n = min(na, nb)
        np.testing.assert_allclose(got["scores"][b, :n], ref["scores"][b, :n], atol=0.02)
    dense = te.dense(imgs)
    assert dense[0].dtype == torch.bfloat16


def test_f15_shared_head_keeps_the_last_levels_amax():
    """F15 (lfdtpu's own, mirrored): TL's norm-free shared head runs int8, and
    calibrate_module_amax keeps its merge units' LAST call (level 4), equal
    to lfdtpu's. Here (TL-S, seeded, 64x64) level 3's merge output is about
    twice the amax kept for it, so the chain clips it at 127."""
    from lfdtpu_torch.deploy.int8_net import _float_walk, net_structure

    jdet, variables, tdet = jax_and_port("TL-S")
    frames = [_frames(11, 1)]
    pre = make_device_preprocess(MEAN, STD)
    got = calibrate_module_amax(tdet, frames, preprocess=pre)
    ref = jax_calibrate(jdet, variables, frames, preprocess=jax_preprocess(MEAN, STD))
    key = "_head.head0_merge_path.0#out"
    assert got[key] == pytest.approx(jax_amax_to_port(ref, tdet.net)[key], rel=1e-5)
    calls = []
    x = pre(torch.as_tensor(frames[0])).float()
    with torch.inference_mode():
        _float_walk(net_structure(tdet.net), x,
                    lambda k, t: calls.append(float(t.abs().amax())) if k == key else None)
    assert len(calls) == 5 and got[key] == pytest.approx(calls[-1], rel=1e-6)
    level = int(np.argmax(calls[:-1]))
    assert calls[level] > 1.5 * got[key]  # an earlier level outgrows the range kept for it
    cap = {"_head.head0_merge_path.0": None}
    chain = Int8Chain(tdet.net, got)
    chain.head = chain.head[:level + 1]  # the capture keeps the last level run
    with torch.inference_mode():
        chain(x, capture=cap)
    x8, s = cap["_head.head0_merge_path.0"]
    assert s == pytest.approx(got[key] / 127.0)
    assert int(x8.max()) == 127  # clipped


# ------------------------------------------- tests/test_deploy.py's int8 tests

def test_int8_quantize_close():
    _, _, tdet = _tiny_pair()
    q = quantize_net_int8(tdet.net)
    k0, q0 = tdet.net._backbone._stem[0].weight, q._backbone._stem[0].weight
    assert not torch.allclose(k0, q0)
    rel = (k0 - q0).abs().max() / (k0.abs().max() + 1e-9)
    assert rel < 0.02  # <= 1/127 rounding


def test_int8_calibrator_cache(tmp_path):
    cache = str(tmp_path / "calib.npy")
    c = Int8Calibrator(cache)
    assert not c.has_cache()
    c.update(np.full((1, 4, 4, 3), -7.0))
    assert c.input_amax == 7.0
    c.save()
    c2 = Int8Calibrator(cache)
    assert c2.has_cache() and c2.input_amax == 7.0


def test_int8_fused_chain_close_and_stays_int8(monkeypatch):
    """Close to f32 (lfdtpu's criteria), and the backbone and neck convs are
    real int8 convs: K4's wrapper runs them (lfdtpu counts int32 convs in the
    jaxpr; the wrapper's launch counter ticks on the card only, so the calls
    are counted here)."""
    _, _, tdet = _tiny_pair()
    pre = make_device_preprocess((0.5,) * 3, (0.5,) * 3)
    img = _frames(0)
    amax = calibrate_module_amax(tdet, [img], preprocess=pre)
    assert any(k.endswith("#out") for k in amax) and "__input__#out" in amax
    x = pre(torch.as_tensor(img)).float()
    calls = _count_k4_calls(monkeypatch)
    with torch.inference_mode():
        ref_cls, ref_reg = tdet.net(x)
        cls8, reg8 = int8_fused_apply(tdet.net, x, amax)
    n = calls[0]
    for got, ref in ((cls8, ref_cls), (reg8, ref_reg)):
        cc = np.corrcoef(got.numpy().ravel(), ref.numpy().ravel())[0, 1]
        assert cc > 0.95, cc
        ratio = float(got.abs().mean() / ref.abs().mean())
        assert 0.8 < ratio < 1.25, ratio
    assert n >= 8, n  # stem 2, blocks 2 x 2 + 1 shortcut, neck 2


def test_int8_engine_end_to_end():
    _, _, tdet = _tiny_pair()
    pre = make_device_preprocess((0.5,) * 3, (0.5,) * 3)
    eng = compile_inference(tdet, (64, 64), "int8", preprocess=pre,
                            classification_threshold=0.01, device="cpu")
    out = eng(_frames(0), [64.0, 64.0])
    assert int(out["count"][0]) >= 0
    assert np.isfinite(out["scores"].numpy()).all()
    with pytest.raises(ValueError, match="kernel_stem"):
        compile_inference(tdet, (64, 64), "int8", preprocess=pre, kernel_stem=True,
                          device="cpu")


def test_int8_engine_bf16_head():
    _, _, tdet = _tiny_pair()
    pre = make_device_preprocess((0.5,) * 3, (0.5,) * 3)
    img = _frames(0)
    amax = calibrate_module_amax(tdet, [img], preprocess=pre)
    kw = dict(preprocess=pre, classification_threshold=0.01, act_scales=amax, device="cpu")
    plain = compile_inference(tdet, (64, 64), "int8", **kw)
    bfh = compile_inference(tdet, (64, 64), "int8", int8_head_dtype="bf16", **kw)
    a, b = plain(img, [64.0, 64.0]), bfh(img, [64.0, 64.0])
    sa = np.sort(a["scores"].numpy().ravel())[::-1][:32]
    sb = np.sort(b["scores"].numpy().ravel())[::-1][:32]
    np.testing.assert_allclose(sa, sb, atol=0.05)


def test_int8_chain_refuses_other_nets():
    from lfdtpu_torch.models import fcos, heads, necks, resnet

    rn = resnet.ResNet(depth=18, base_channels=8, out_indices=((2, 1), (3, 1), (4, 1)))
    det = fcos.FCOS(rn, necks.FPN(rn.num_output_channels_list, rn.num_output_strides_list,
                                  16, 5), heads.FCOSHead(2, 16, 5, 16, 1), num_classes=2)
    with pytest.raises(ValueError, match="LFD nets"):
        calibrate_module_amax(det, [_frames(0)])
