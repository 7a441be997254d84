# The image height split over a mesh's spatial axis (lfdtpu_torch/parallel/
# spatial.py, make_mesh(spatial=k), make_eval_step(spatial=True),
# compile_inference(mesh=)) on the CPU, against lfdtpu and against the
# port's one process.
#
# Single process (no spawn):
#   - owned_rows, needed_rows, kernel_window and upsample_rows against brute
#     force: every height 1-40 over 1-5 ranks; convs of kernel 1, 3 and 7 at
#     stride 1 and 2, the 5-row window of a FasterBlock's two K3 launches,
#     the 3x3/s2 max pool; the nearest-exact upsample between every pair of
#     heights, read off torch's own resize of an index map;
#   - what must raise: a spatial axis that does not divide the world, a
#     captured engine on a mesh of several ranks, a device that is not the
#     mesh's, saving a mesh engine, a strip of the wrong height.
# One 8-rank spawn (2 data x 4 spatial, lfdtpu's test mesh), each rank a
# fresh process that imports no jax (`python -m tests.test_torch_spatial
# RANK WORLD PORT JOB OUT`, tests/test_torch_distributed.py::run_ranks):
#   - make_mesh(spatial=4)'s coordinates and groups are lfdtpu's
#     `reshape(n // spatial, spatial)` layout;
#   - make_eval_step(spatial=True) at 64x64, batch 2, for tiny_lfd, LFDv2
#     and the FCOS of build_pair's size (ResNet, FPN with its upsamples, a
#     GroupNorm head; its deepest levels have one row, which one rank of
#     four owns), on every rank equal to lfdtpu's spatially sharded step and
#     to its unsharded step at lfdtpu's tolerance (rtol 1e-4, atol 1e-5,
#     tests/test_parallel.py:88-92);
#   - compile_inference(mesh=) in fp32 in lfdtpu's setting
#     (tests/test_deploy.py::test_spmd_mesh_engine_matches_single_device:
#     batch 2, valid extents [60, 57], threshold 0.01): counts equal to
#     lfdtpu's mesh engine, boxes at rtol 1e-4 / atol 1e-3, scores at rtol
#     1e-4 / atol 1e-4;
#   - WIDERFACE-L's bf16 engine with kernel_convs and kernel_stem (the
#     kernels' plain versions on the CPU) against the port's one-process
#     engine: the dense outputs within BF16_DENSE_TOL of its (see there),
#     counts equal and rows within bf16 rounding;
#   - WIDERFACE-L's int8 engines (float32 and bf16 heads) on lfdtpu's amax:
#     every int8 edge of the chain on each rank's rows equal to the
#     one-process chain's rows, bit for bit (K4's plain version accumulates
#     exactly), and the rows equal to lfdtpu's int8 engine's at
#     tests/test_torch_int8.py's tolerances.
# One 3-rank spawn (spatial 3 at 100x64: every level splits unevenly, the
# deepest ones leave ranks without a row): the eval step of tiny_lfd and of
# the FCOS (its upsamples 4 -> 7 -> 13 rows: non-integer ratios) against the
# port's unsharded step, the fp32 engine and WIDERFACE-L's int8 chain
# against one process; make_mesh(spatial=2) raises there.
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import join_group, port_detector, run_ranks

torch.set_num_threads(1)

HW = (64, 64)
UNEVEN_HW = (100, 64)
RTOL, ATOL = 1e-4, 1e-5            # lfdtpu's, tests/test_parallel.py:88-92
BOX_TOL, SCORE_TOL = (1e-4, 1e-3), (1e-4, 1e-4)  # tests/test_deploy.py:496-501
INT8_TOL = 1e-4                    # tests/test_torch_int8.py DENSE_TOL
# bf16 on strips against one process: the kernels' plain versions and the
# other convs sum in float32 in an order that depends on the rows a strip
# holds, so a bf16 rounding of a conv output can fall the other way; one
# such 1-ulp flip (2^-8 relative) moves what the layers after it compute
# by as much again. Half of bf16's 8 bits, against the outputs' largest
# magnitude, holds the dense outputs while any real fault (a wrong row, a
# missing halo) moves them by O(1).
BF16_DENSE_TOL = 2.0 ** -4
BF16_BOX_PX, BF16_SCORE = 1.0, 0.02  # rows: a box within a pixel, a score within bf16's 2^-6
MEAN, STD = (0.45, 0.5, 0.55), (0.25, 0.25, 0.3)  # tests/test_torch_int8.py's
EVAL_KINDS = ("lfd", "lfdv2", "fcos")
INT8_HEADS = (None, "bf16")
GN = dict(type="GroupNorm", num_groups=8)


# ------------------------------------------------- nets the ranks build

def port_fcos():
    """The port's half of tests/test_torch_resnet_fpn.py::build_pair (FCOS):
    a ResNet-18 of 16 base channels tapped at strides 8, 16, 32, an FPN of
    32 channels and 5 levels, a GroupNorm(8) FCOSHead of 2 layers."""
    from lfdtpu_torch.models import FCOS, FPN, FCOSHead, ResNet
    from lfdtpu_torch.ops import loss_wrappers as TW

    bb = ResNet(depth=18, base_channels=16, out_indices=((2, 1), (3, 1), (4, 1)),
                norm_cfg=dict(type="BN"))
    neck = FPN(bb.num_output_channels_list, bb.num_output_strides_list,
               num_output_channels=32, num_outputs=5, relu_before_extra=True)
    strides = neck.num_output_strides_list
    ranges = tuple((32 * i, 32 * (i + 1)) for i in range(len(strides) - 1)) + ((128, 1e8),)
    return FCOS(bb, neck, FCOSHead(3, 32, len(strides), 32, 2, GN),
                classification_loss_func=TW.FocalLoss(), regression_loss_func=TW.IoULoss(),
                num_classes=3, regression_ranges=ranges, point_strides=strides)


def build(kind, state_dict):
    """The port detector of `kind` ("lfd", "lfdv2", "fcos" or a zoo name)
    with `state_dict` loaded, in eval mode."""
    from lfdtpu_torch import zoo

    if kind == "fcos":
        det = port_fcos()
    elif kind in zoo.ZOO:
        det = zoo.ZOO[kind]()
    else:
        det = port_detector(kind)
    det.net.load_state_dict(state_dict, strict=True)
    det.net.eval()
    return det


def engine_kwargs(case):
    from lfdtpu_torch.deploy import make_device_preprocess

    kw = dict(case["kwargs"])
    kw["preprocess"] = make_device_preprocess(*case["norm"])
    return kw


# ------------------------------------------------------------- one rank

def worker(rank, world, port, job_path, out_dir):
    """One rank: the mesh, every eval case and every engine case of the job
    on its rows, and what must raise."""
    import torch.distributed as dist

    from lfdtpu_torch.deploy import compile_inference
    from lfdtpu_torch.parallel import make_eval_step, make_mesh
    from lfdtpu_torch.parallel.data_parallel import TrainState

    join_group(rank, world, port)
    job = torch.load(job_path, weights_only=False)
    out = {}
    if int(world) % 2:
        try:
            make_mesh("cpu", spatial=2)
            out["odd_split"] = None
        except ValueError as e:
            out["odd_split"] = str(e)
    mesh = make_mesh("cpu", spatial=job["spatial"])
    out["mesh"] = dict(rank=mesh.rank, size=mesh.size, spatial_rank=mesh.spatial_rank,
                       spatial=mesh.spatial,
                       data=dist.get_process_group_ranks(mesh.group),
                       across=dist.get_process_group_ranks(mesh.spatial_group))
    out["eval"] = {}
    for name, case in job["eval"].items():
        det = build(case["kind"], case["weights"])
        before = {k: v.clone() for k, v in det.net.state_dict().items()}
        det.net.train()
        outs = make_eval_step(det, mesh, spatial=True)(TrainState(det.net, None),
                                                       case["images"])
        untouched = det.net.training and all(
            torch.equal(v, before[k]) for k, v in det.net.state_dict().items())
        out["eval"][name] = ([o.numpy() for o in outs], untouched)
    out["engines"] = {}
    for name, case in job["engines"].items():
        det = build(case["kind"], case["weights"])
        engine = compile_inference(det, case["hw"], case["precision"], mesh=mesh,
                                   batch_size=len(case["frames"]), **engine_kwargs(case))
        rows = {k: v.numpy() for k, v in engine(case["frames"], case["vhw"]).items()}
        dense = [d.float().numpy() for d in engine.dense(case["frames"])]
        edges = None
        if case["precision"] == "int8":
            capture = dict.fromkeys(engine.spatial.module.int8_edges())
            x, _ = engine._local(case["frames"], case["vhw"])
            with torch.inference_mode():
                engine.spatial(engine.program.preprocess(x).float(), capture=capture)
            edges = {k: v[0].numpy() for k, v in capture.items()}
        out["engines"][name] = dict(rows=rows, dense=dense, edges=edges)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# ------------------------------------------------------------- the parent

def _images(seed, hw, b=2):
    return np.random.RandomState(seed).uniform(-1.0, 1.0, (b,) + hw + (3,)).astype(np.float32)


def _frames(seed, hw, b=2):
    return np.random.RandomState(seed).randint(0, 255, (b,) + hw + (3,)).astype(np.uint8)


def _jax_eval_pairs():
    """{kind: (lfdtpu detector, its numpy variables, port state_dict)}."""
    import jax

    from lfdtpu_torch.execution.jax_convert import jax_variables_to_state_dict
    from tests.test_torch_bridge import randomize_norms
    from tests.test_torch_distributed import jax_detector
    from tests.test_torch_resnet_fpn import build_pair

    pairs = {}
    for kind in ("lfd", "lfdv2"):
        jdet = jax_detector(kind)
        variables = randomize_norms(jdet.init(jax.random.PRNGKey(11), HW), 11)
        pairs[kind] = (jdet, variables,
                       jax_variables_to_state_dict(variables, port_detector(kind).net))
    jdet, variables, tdet = build_pair(seed=11)
    pairs["fcos"] = (jdet, variables, tdet.net.state_dict())
    return pairs


def _int8_case(tdet, amax, head, hw, frames):
    return dict(kind="WIDERFACE-L", weights=tdet.net.state_dict(), hw=hw, precision="int8",
                frames=frames, vhw=np.asarray([[hw[0], hw[1]], [hw[0] - 14, 41]], np.float32),
                norm=(MEAN, STD),
                kwargs=dict(act_scales=amax, classification_threshold=0.01,
                            int8_head_dtype=head))


def _one_process(case):
    """The port's one-process engine of an engine case, its rows, dense
    outputs and (int8) chain edges of the whole frames."""
    from lfdtpu_torch.deploy import compile_inference

    det = build(case["kind"], case["weights"])
    engine = compile_inference(det, case["hw"], case["precision"], device="cpu",
                               batch_size=len(case["frames"]), **engine_kwargs(case))
    rows = {k: v.numpy() for k, v in engine(case["frames"], case["vhw"]).items()}
    dense = [d.float().numpy() for d in engine.dense(case["frames"])]
    edges = None
    if case["precision"] == "int8":
        capture = dict.fromkeys(engine.int8_chain.int8_edges())
        with torch.inference_mode():
            x = engine.program.preprocess(torch.as_tensor(case["frames"])).float()
            engine.int8_chain(x, capture=capture)
        edges = {k: v[0].numpy() for k, v in capture.items()}
    return dict(rows=rows, dense=dense, edges=edges)


@pytest.fixture(scope="module")
def mesh8(tmp_path_factory):
    """The 8-rank spawn (2 x 4) and its references."""
    import jax
    import jax.numpy as jnp

    from lfdtpu.deploy import compile_inference as jax_compile
    from lfdtpu.deploy import make_device_preprocess as jax_preprocess
    from lfdtpu.deploy.int8_net import calibrate_module_amax as jax_calibrate
    from lfdtpu_torch.execution.jax_convert import jax_amax_to_port, jax_variables_to_state_dict
    from tests.test_deploy import _engine_setup
    from tests.test_torch_bridge import jax_and_port

    pairs = _jax_eval_pairs()
    images = _images(3, HW)
    eval_cases = {kind: dict(kind=kind, weights=sd, images=images)
                  for kind, (_, _, sd) in pairs.items()}
    jdet, variables, img = _engine_setup()
    frames2 = np.concatenate([img, img[:, ::-1]], axis=0)
    vhw = np.asarray([60.0, 57.0], np.float32)
    engines = {"fp32": dict(kind="lfd", weights=jax_variables_to_state_dict(
        variables, port_detector("lfd").net), hw=HW, precision="fp32", frames=frames2, vhw=vhw,
        norm=((0.5,) * 3, (0.5,) * 3), kwargs=dict(classification_threshold=0.01))}
    jl, vl, tl = jax_and_port("WIDERFACE-L")
    engines["bf16_kernels"] = dict(
        kind="WIDERFACE-L", weights=tl.net.state_dict(), hw=HW, precision="bf16",
        frames=_frames(4, HW), vhw=np.asarray([[64, 64], [50, 41]], np.float32),
        norm=(MEAN, STD), kwargs=dict(classification_threshold=0.01, kernel_convs=True,
                                      kernel_stem=True))
    amax = jax_calibrate(jl, vl, [_frames(7, HW), _frames(8, HW)],
                         preprocess=jax_preprocess(MEAN, STD))
    port_amax = jax_amax_to_port(amax, tl.net)
    for head in INT8_HEADS:
        engines[f"int8_{head or 'float32'}"] = _int8_case(tl, port_amax, head, HW,
                                                          _frames(9, HW))
    tmp = tmp_path_factory.mktemp("spatial8")
    torch.save(dict(spatial=4, eval=eval_cases, engines=engines), tmp / "job.pt")
    ranks = run_ranks("test_torch_spatial", tmp / "job.pt", tmp, world=8)

    jax_eval = {}
    from lfdtpu.parallel import make_eval_step as jax_eval_step
    from lfdtpu.parallel import make_mesh as jax_make_mesh
    from lfdtpu.parallel.data_parallel import TrainState
    from lfdtpu.parallel.mesh import spatial_image_sharding

    jmesh = jax_make_mesh(jax.devices()[:8], spatial=4)
    for kind, (jd, v, _) in pairs.items():
        state = TrainState(v["params"], v["batch_stats"], None)
        sharded = jax_eval_step(jd, jmesh, spatial=True)(
            state, jax.device_put(images, spatial_image_sharding(jmesh)))
        whole = jax_eval_step(jd, None)(state, jnp.asarray(images))
        jax_eval[kind] = ([np.asarray(o) for o in sharded], [np.asarray(o) for o in whole])
    pre = jax_preprocess((0.5,) * 3, (0.5,) * 3)
    spmd = jax_compile(jdet, variables, HW, "fp32", preprocess=pre,
                       classification_threshold=0.01, batch_size=2, mesh=jmesh)
    assert spmd.spmd_mesh is jmesh
    jax_rows = {"fp32": {k: np.asarray(v) for k, v in
                         spmd(frames2, jnp.asarray(vhw)).items()}}
    for head in INT8_HEADS:
        case = engines[f"int8_{head or 'float32'}"]
        je = jax_compile(jl, vl, HW, "int8", act_scales=amax, preprocess=jax_preprocess(MEAN, STD),
                         batch_size=2, classification_threshold=0.01, int8_head_dtype=head)
        jax_rows[f"int8_{head or 'float32'}"] = {
            k: np.asarray(v) for k, v in je(jnp.asarray(case["frames"]),
                                            jnp.asarray(case["vhw"])).items()}
    single = {name: _one_process(case) for name, case in engines.items()}
    return dict(ranks=ranks, jax_eval=jax_eval, jax_rows=jax_rows, single=single,
                jmesh=np.vectorize(lambda d: d.id)(jmesh.devices), engines=engines)


@pytest.fixture(scope="module")
def mesh3(tmp_path_factory):
    """The 3-rank spawn (spatial 3 at 100x64) and the port's one-process
    references."""
    from lfdtpu_torch.parallel import make_eval_step
    from lfdtpu_torch.parallel.data_parallel import TrainState
    from tests.test_torch_bridge import jax_and_port

    pairs = _jax_eval_pairs()
    images = _images(5, UNEVEN_HW)
    eval_cases = {kind: dict(kind=kind, weights=pairs[kind][2], images=images)
                  for kind in ("lfd", "fcos")}
    _, _, tl = jax_and_port("WIDERFACE-L")
    from lfdtpu_torch.deploy import calibrate_module_amax, make_device_preprocess

    amax = calibrate_module_amax(tl.net, [_frames(7, UNEVEN_HW)],
                                 preprocess=make_device_preprocess(MEAN, STD))
    engines = {
        "fp32": dict(kind="lfd", weights=pairs["lfd"][2], hw=UNEVEN_HW, precision="fp32",
                     frames=_frames(6, UNEVEN_HW),
                     vhw=np.asarray([[100, 64], [91, 57]], np.float32), norm=(MEAN, STD),
                     kwargs=dict(classification_threshold=0.01)),
        "int8": _int8_case(tl, amax, None, UNEVEN_HW, _frames(9, UNEVEN_HW))}
    tmp = tmp_path_factory.mktemp("spatial3")
    torch.save(dict(spatial=3, eval=eval_cases, engines=engines), tmp / "job.pt")
    ranks = run_ranks("test_torch_spatial", tmp / "job.pt", tmp, world=3)
    whole = {}
    for kind, case in eval_cases.items():
        det = build(kind, case["weights"])
        whole[kind] = [o.numpy() for o in make_eval_step(det)(TrainState(det.net, None),
                                                               images)]
    single = {name: _one_process(case) for name, case in engines.items()}
    return dict(ranks=ranks, whole=whole, single=single, engines=engines)


def _owned(height, parts, index):
    from lfdtpu_torch.parallel import owned_rows

    return owned_rows(height, parts, index)


def _assert_edges(got, ref, parts, index, rows):
    """Every int8 edge of a rank (its batch rows, its owned rows of the
    edge's height) equal to one process's."""
    assert set(got) == set(ref) and got
    for name, a in got.items():
        b = ref[name][rows[0]:rows[1]]
        lo, hi = _owned(b.shape[1], parts, index)
        assert a.dtype == np.int8 and a.shape == b[:, lo:hi].shape, name
        np.testing.assert_array_equal(a, b[:, lo:hi], err_msg=name)


def _assert_same_rows(got, ref, px, score):
    """The same detections in any order (near-equal bf16 scores may swap
    two rows): counts equal, and each of one process's rows matched to a
    row of the same label whose box lies within `px` and score within
    `score`."""
    np.testing.assert_array_equal(got["count"], ref["count"])
    for b, n in enumerate(ref["count"].reshape(-1)):
        free = list(range(n))
        for i in range(n):
            cand = [j for j in free if got["labels"][b, j] == ref["labels"][b, i]]
            assert cand, (b, i)
            j = min(cand, key=lambda j: np.abs(got["boxes"][b, j] - ref["boxes"][b, i]).max())
            assert np.abs(got["boxes"][b, j] - ref["boxes"][b, i]).max() <= px, (b, i)
            assert abs(got["scores"][b, j] - ref["scores"][b, i]) <= score, (b, i)
            free.remove(j)


def _assert_rows(got, ref, box_tol, score_tol):
    assert ref["count"].sum() > 0
    np.testing.assert_array_equal(got["count"], ref["count"])
    for b, n in enumerate(ref["count"].reshape(-1)):
        np.testing.assert_array_equal(got["labels"][b, :n], ref["labels"][b, :n])
        np.testing.assert_allclose(got["boxes"][b, :n], ref["boxes"][b, :n], rtol=box_tol[0],
                                   atol=box_tol[1])
        np.testing.assert_allclose(got["scores"][b, :n], ref["scores"][b, :n],
                                   rtol=score_tol[0], atol=score_tol[1])


# ------------------------------------------------------- 8 ranks: 2 x 4

def test_mesh_coordinates_are_lfdtpus_layout(mesh8):
    """Rank r of make_mesh(spatial=4) over 8 ranks is device r of lfdtpu's
    make_mesh(jax.devices()[:8], spatial=4): its row is the data rank, its
    column the spatial rank; the data group is its column, the spatial
    group its row."""
    layout = mesh8["jmesh"]
    assert layout.shape == (2, 4)
    for r, out in enumerate(mesh8["ranks"]):
        m = out["mesh"]
        (d,), (s,) = np.nonzero(layout == r)
        assert (m["rank"], m["size"], m["spatial_rank"], m["spatial"]) == (d, 2, s, 4)
        assert m["data"] == sorted(layout[:, s].tolist())
        assert m["across"] == sorted(layout[d, :].tolist())


@pytest.mark.parametrize("kind", EVAL_KINDS)
def test_spatial_eval_step_matches_lfdtpus(mesh8, kind):
    sharded, whole = mesh8["jax_eval"][kind]
    for out in mesh8["ranks"]:
        got, untouched = out["eval"][kind]
        assert untouched  # the net's state and train mode as they were
        assert len(got) == len(whole)
        for a, b, c in zip(got, sharded, whole):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)


def test_fp32_mesh_engine_matches_lfdtpus_mesh_engine(mesh8):
    ref = mesh8["jax_rows"]["fp32"]
    for out in mesh8["ranks"]:
        _assert_rows(out["engines"]["fp32"]["rows"], ref, BOX_TOL, SCORE_TOL)


def test_bf16_kernel_mesh_engine_matches_one_process(mesh8):
    ref = mesh8["single"]["bf16_kernels"]
    for out in mesh8["ranks"]:
        got = out["engines"]["bf16_kernels"]
        for a, b in zip(got["dense"], ref["dense"]):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= BF16_DENSE_TOL * np.abs(b).max()
        _assert_same_rows(got["rows"], ref["rows"], BF16_BOX_PX, BF16_SCORE)


@pytest.mark.parametrize("head", INT8_HEADS)
def test_int8_mesh_engine_edges_exact_and_rows_match_lfdtpus(mesh8, head):
    name = f"int8_{head or 'float32'}"
    ref = mesh8["single"][name]
    for r, out in enumerate(mesh8["ranks"]):
        got = out["engines"][name]
        d, s = divmod(r, 4)
        _assert_edges(got["edges"], ref["edges"], 4, s, (d, d + 1))
        if head is None:
            _assert_rows(got["rows"], mesh8["jax_rows"][name], (INT8_TOL, 1e-3),
                         (INT8_TOL, 1e-6))
        else:  # tests/test_torch_int8.py::test_int8_bf16_head_engine_matches_lfdtpus
            jref = mesh8["jax_rows"][name]
            for b in range(2):
                na, nb = int(jref["count"][b]), int(got["rows"]["count"][b])
                assert na > 0 and abs(na - nb) <= 1, (na, nb)
                n = min(na, nb)
                np.testing.assert_allclose(got["rows"]["scores"][b, :n],
                                           jref["scores"][b, :n], atol=0.02)
            _assert_rows(got["rows"], ref["rows"], (0, 1e-3), (0, 1e-6))


# ------------------------------------------------- 3 ranks: spatial 3

@pytest.mark.parametrize("kind", ("lfd", "fcos"))
def test_uneven_split_eval_step_matches_one_process(mesh3, kind):
    for out in mesh3["ranks"]:
        got, untouched = out["eval"][kind]
        assert untouched
        for a, b in zip(got, mesh3["whole"][kind]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_uneven_split_engines_match_one_process(mesh3):
    for s, out in enumerate(mesh3["ranks"]):
        _assert_rows(out["engines"]["fp32"]["rows"], mesh3["single"]["fp32"]["rows"],
                     BOX_TOL, SCORE_TOL)
        got, ref = out["engines"]["int8"], mesh3["single"]["int8"]
        _assert_edges(got["edges"], ref["edges"], 3, s, (0, 2))
        for a, b in zip(got["dense"], ref["dense"]):
            np.testing.assert_allclose(a, b, rtol=INT8_TOL, atol=1e-6)
        _assert_rows(got["rows"], ref["rows"], (INT8_TOL, 1e-3), (INT8_TOL, 1e-6))


def test_spatial_axis_must_divide_the_world(mesh3):
    import jax

    from lfdtpu.parallel import make_mesh as jax_make_mesh
    from lfdtpu_torch.parallel import make_mesh

    for out in mesh3["ranks"]:
        assert out["odd_split"] is not None and "does not divide" in out["odd_split"]
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh("cpu", spatial=2)  # no process group: a world of one
    with pytest.raises(AssertionError):
        jax_make_mesh(jax.devices()[:3], spatial=2)


# ------------------------------------------------- one process: the rows

def _brute_needed(lo, hi, height, k, s, p):
    rows = {i * s - p + t for i in range(lo, hi) for t in range(k)}
    rows = [r for r in rows if 0 <= r < height]
    return (min(rows), max(rows) + 1) if rows else (0, 0)


WINDOWS = [(1, 1, 0), (1, 2, 0), (3, 1, 1), (3, 2, 1), (7, 1, 3), (7, 2, 3), (5, 1, 2),
           ("pool", 2, 1)]


def test_owned_rows_split_every_height():
    from lfdtpu_torch.parallel import owned_rows

    for height in range(1, 41):
        for parts in range(1, 6):
            rows = [owned_rows(height, parts, s) for s in range(parts)]
            assert rows[0][0] == 0 and rows[-1][1] == height
            assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
            assert rows == [(s * height // parts, (s + 1) * height // parts)
                            for s in range(parts)]


@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_needed_rows_and_kernel_window_against_brute_force(window):
    """needed_rows is the set of rows the owned outputs read; a conv or max
    pool run as it is on kernel_window's rows, then cropped, gives the
    whole map's owned rows exactly (float64), and reads them all."""
    import torch.nn.functional as F

    from lfdtpu_torch.parallel import kernel_window, needed_rows, out_height, owned_rows

    k, s, p = window
    pool = k == "pool"
    k = 3 if pool else k
    g = torch.Generator().manual_seed(k * 10 + s)
    w = torch.randn(2, 2, k, k, generator=g, dtype=torch.float64)

    def op(x):
        return F.max_pool2d(x, k, s, p) if pool else F.conv2d(x, w, stride=s, padding=p)

    for height in range(1, 41):
        if height + 2 * p < k:
            continue
        x = torch.randn(1, 2, height, 3, generator=g, dtype=torch.float64)
        whole = op(x)
        h_out = out_height(height, k, s, p)
        assert whole.shape[2] == h_out
        for parts in range(1, 6):
            for r in range(parts):
                lo, hi = owned_rows(h_out, parts, r)
                need = needed_rows(lo, hi, height, k, s, p)
                assert need == _brute_needed(lo, hi, height, k, s, p)
                if hi == lo:
                    continue
                r0, r1, j0 = kernel_window(lo, hi, height, k, s, p)
                assert r0 % s == 0 and r0 <= need[0] and r1 >= need[1]
                got = op(x[:, :, r0:r1])[:, :, j0:j0 + hi - lo]
                assert torch.equal(got, whole[:, :, lo:hi]), (height, parts, r)


@pytest.mark.parametrize("window", [w for w in WINDOWS if w[0] not in (1, "pool")], ids=str)
def test_strip_gemm_conv_equals_the_conv_on_kernel_window(window, monkeypatch):
    """spatial._conv_rows, the float convs' path on strips: the kept output
    rows of the conv run on kernel_window's rows, for every rank of 1-4,
    batch 2, with a bias, in one chunk and in chunks of a few rows
    (float64, within 1e-12 of F.conv2d's)."""
    from lfdtpu_torch.parallel import spatial

    k, s, p = window
    g = torch.Generator().manual_seed(k * 10 + s)
    conv = torch.nn.Conv2d(3, 4, k, s, p).double()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g, dtype=torch.float64))
        conv.bias.copy_(torch.randn(4, generator=g, dtype=torch.float64))
    for unfold_bytes in (spatial._UNFOLD_BYTES, 1):
        monkeypatch.setattr(spatial, "_UNFOLD_BYTES", unfold_bytes)
        for height in (k, 17, 40):
            x = torch.randn(2, 3, height, 9, generator=g, dtype=torch.float64)
            whole = conv(x)
            h_out = whole.shape[2]
            for parts in range(1, 5):
                for r in range(parts):
                    lo, hi = spatial.owned_rows(h_out, parts, r)
                    if hi == lo:
                        continue
                    r0, r1, j0 = spatial.kernel_window(lo, hi, height, k, s, p)
                    got = spatial._conv_rows(conv, x[:, :, r0:r1], j0, hi - lo)
                    ref = whole[:, :, lo:hi]
                    assert got.shape == ref.shape
                    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_upsample_rows_against_brute_force():
    """The rows that a nearest-exact resize's owned output rows read, found
    by resizing an index map whole (float32 and float64 data); torch's map
    is floor((i + 0.5) * in / out), at a few sizes one row below it."""
    import torch.nn.functional as F

    from lfdtpu_torch.parallel import owned_rows, upsample_rows

    off = 0
    for dtype in (torch.float32, torch.float64):
        for h_in in range(1, 41):
            for h_out in range(1, 41):
                x = torch.arange(h_in, dtype=dtype).view(1, 1, -1, 1).expand(1, 2, h_in, 3)
                read = F.interpolate(x, size=(h_out, 5), mode="nearest-exact")[0, 1, :, 2]
                read = read.long().tolist()
                exact = [min((2 * i + 1) * h_in // (2 * h_out), h_in - 1) for i in range(h_out)]
                assert all(e - 1 <= r <= e for r, e in zip(read, exact))
                off += read != exact
                for parts in range(1, 6):
                    for r in range(parts):
                        lo, hi = owned_rows(h_out, parts, r)
                        want = (min(read[lo:hi]), max(read[lo:hi]) + 1) if hi > lo else (0, 0)
                        assert upsample_rows(lo, hi, h_in, h_out, dtype) == want
    assert off  # the brute force tells torch's rounding from the exact quotient


def test_spatial_image_rows_split_the_batch_and_the_height():
    """lfdtpu's spatial_image_sharding as rows: rank (1, 2) of a 2 x 4 mesh
    takes the second half of the batch and the third quarter of the
    height (floor(s * H / S)), uneven heights included."""
    from lfdtpu_torch.parallel import Mesh, spatial_image_rows

    mesh = Mesh(2, 1, torch.device("cpu"), None, 4, 2, None)
    assert mesh.world_size == 8
    assert spatial_image_rows(mesh, (4, 64, 64, 3)) == ((2, 4), (32, 48))
    assert spatial_image_rows(mesh, (2, 101, 64, 3)) == ((1, 2), (50, 75))


# ------------------------------------------------ one process: must raise

def _fake_mesh(spatial=2):
    """A mesh of several ranks without a process group: enough for what
    compile_inference checks before any collective."""
    from lfdtpu_torch.parallel import Mesh

    return Mesh(1, 0, torch.device("cpu"), None, spatial, 0, None)


def test_mesh_engine_refusals(tmp_path):
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess
    from lfdtpu_torch.deploy.engine_io import save_engine

    det = port_detector("lfd")
    det.init(torch.Generator().manual_seed(0))
    pre = make_device_preprocess(MEAN, STD)
    mesh = _fake_mesh()
    assert mesh.world_size == 2
    with pytest.raises(ValueError, match="cannot be captured"):
        compile_inference(det, HW, "fp32", preprocess=pre, mesh=mesh, captured=True)
    with pytest.raises(ValueError, match="not the mesh's device"):
        compile_inference(det, HW, "fp32", preprocess=pre, mesh=mesh, device="meta")
    engine = compile_inference(det, HW, "fp32", preprocess=pre, mesh=mesh)
    assert engine.mesh is mesh and not engine.captured and engine.spatial is not None
    with pytest.raises(ValueError, match="cannot be saved"):
        save_engine(engine, tmp_path / "mesh.lfd")


def test_one_rank_mesh_builds_todays_engine():
    """A mesh of one rank (without a process group here) builds the engine
    of mesh=None, bit-equal."""
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess
    from lfdtpu_torch.parallel import Mesh

    det = port_detector("lfd")
    det.init(torch.Generator().manual_seed(0))
    pre = make_device_preprocess(MEAN, STD)
    frames = _frames(1, HW)
    a = compile_inference(det, HW, "fp32", preprocess=pre, batch_size=2, device="cpu")
    b = compile_inference(det, HW, "fp32", preprocess=pre, batch_size=2,
                          mesh=Mesh(1, 0, torch.device("cpu")))
    assert type(b) is type(a) and b.mesh is None
    ra, rb = a(frames, HW), b(frames, HW)
    assert all(torch.equal(ra[k], rb[k]) for k in ra)


def test_a_strip_of_the_wrong_height_raises():
    """A swapped module handed a strip that is not its rank's rows (or its
    window) raises; nothing runs the plain conv on it instead."""
    from lfdtpu_torch.parallel import spatial_parallel

    det = port_detector("lfd")
    det.init(torch.Generator().manual_seed(0))
    spatial = spatial_parallel(det.net.eval(), _fake_mesh()).eval()
    x = torch.zeros(1, 64, 64, 3)
    assert spatial.input_rows(x.shape, x.dtype) == (0, 32)  # rows 0-31 of 64 and no halo
    with pytest.raises(ValueError, match="input holds 30 rows"):
        spatial(x[:, :30], 64)


if __name__ == "__main__" and len(sys.argv) > 1:
    worker(*sys.argv[1:])
