# lfdtpu's package namespaces in the port. Every public name of every
# lfdtpu package `__init__` (its `__all__`, read by `ast` without importing
# lfdtpu) is in the matching lfdtpu_torch package, under the port's name
# where RENAMED says so, or it is one of NOT_PORTED, each with its reason
# (ROADMAP item 10). The allowlists are held too: each entry names a public
# lfdtpu name that the port really lacks.
#
# Beside the names: lfd_resnet_output_info against lfdtpu's for every zoo
# backbone and the plans' defaults, and against a built LFDResNet; and
# bias_param_labels against lfdtpu's, carried through the weight bridge
# (lfdtpu's labels as constant leaves, 1.0 for "bias" and 0.0 for "other",
# through jax_variables_to_state_dict) for a shared-head LFD, an LFDv2 and
# an FCOS.
import ast
import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lfdtpu import zoo as jax_zoo
from lfdtpu.execution.optim import bias_param_labels as jax_bias_param_labels
from lfdtpu.models.lfd_resnet import lfd_resnet_output_info as jax_output_info
from lfdtpu.models.lfdv2 import LFDv2 as JLFDv2
from lfdtpu_torch import zoo as torch_zoo
from lfdtpu_torch.execution import bias_param_labels
from lfdtpu_torch.execution.jax_convert import jax_variables_to_state_dict
from lfdtpu_torch.models import LFDResNet, LFDv2, lfd_resnet_output_info
from tests.test_torch_bridge import jax_and_port
from tests.test_torch_lfdv2 import variant
from tests.test_torch_resnet_fpn import build_pair

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# lfdtpu name -> the port's name for the same function
RENAMED = {
    ("lfdtpu.ops", "batched_nms_jax"): "batched_nms",
    ("lfdtpu.ops", "multiclass_nms_jax"): "multiclass_nms",
    ("lfdtpu.deploy", "quantize_variables_int8"): "quantize_net_int8",
}
# lfdtpu names the port does not carry (ROADMAP item 10)
NOT_PORTED = {
    ("lfdtpu.execution", "OptaxOptimizer"):
        "optax's API: the port's optimizers are torch.optim ones",
    ("lfdtpu.models", "ConvNormAct"):
        "a flax module: the port builds conv, norm and act as torch modules (conv_norm_act)",
    ("lfdtpu.models", "Norm"):
        "a flax module: the port uses torch's BatchNorm2d and GroupNorm (norm_from_cfg)",
    ("lfdtpu.parallel", "batch_sharding"):
        "a GSPMD sharding: a torch rank loads its own rows (DataLoader.shard)",
    ("lfdtpu.parallel", "replicated_sharding"):
        "a GSPMD sharding: torch keeps a replica on each rank (DDP)",
    ("lfdtpu.deploy", "int8_interception"):
        "the legacy per-conv int8 interceptor: the port runs the int8 chain (Int8Chain)",
    ("lfdtpu.deploy", "int8_apply"):
        "the legacy per-conv int8 interceptor: the port runs the int8 chain (Int8Chain)",
    ("lfdtpu.deploy", "calibrate_activation_scales"):
        "the legacy interceptor's calibration: the port's is calibrate_module_amax",
    ("lfdtpu.deploy", "ActScaleObserver"):
        "the legacy interceptor's observer: the port's is calibrate_module_amax",
    ("lfdtpu.execution", "convert_reference_state_dict"):
        "the port's state_dict names are the reference's: it needs no converter",
    ("lfdtpu.execution", "load_reference_checkpoint"):
        "the port's state_dict names are the reference's: load_checkpoint reads them",
}
NOT_PORTED_PACKAGES = {
    "lfdtpu.native": "the C++ host NMS: the port's host NMS is torch's (ops.nms)",
}


def public_names(path):
    """The names a package __init__ exports: its __all__, else its
    top-level imports and definitions without a leading underscore."""
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
    return [n for n in names if not n.startswith("_")]


def lfdtpu_packages():
    out = {}
    for root, _, files in os.walk(os.path.join(ROOT, "lfdtpu")):
        if "__init__.py" in files:
            package = os.path.relpath(root, ROOT).replace(os.sep, ".")
            out[package] = public_names(os.path.join(root, "__init__.py"))
    return dict(sorted(out.items()))


PACKAGES = lfdtpu_packages()


def test_the_walk_sees_every_package():
    assert set(PACKAGES) == {"lfdtpu", "lfdtpu.data", "lfdtpu.deploy", "lfdtpu.evaluation",
                             "lfdtpu.execution", "lfdtpu.models", "lfdtpu.native",
                             "lfdtpu.ops", "lfdtpu.parallel"}
    assert PACKAGES["lfdtpu"] == ["ops"] and len(PACKAGES["lfdtpu.ops"]) == 32


@pytest.mark.parametrize("package", [p for p in PACKAGES if p not in NOT_PORTED_PACKAGES])
def test_every_public_name_is_in_the_port(package):
    port = importlib.import_module("lfdtpu_torch" + package[len("lfdtpu"):])
    missing = []
    for name in PACKAGES[package]:
        if (package, name) in NOT_PORTED:
            assert not hasattr(port, name), f"{name} is ported: take it off NOT_PORTED"
            continue
        ported = RENAMED.get((package, name), name)
        if not hasattr(port, ported):
            missing.append(ported)
    assert not missing, f"{port.__name__} lacks {missing}"


def test_the_allowlists_name_real_lfdtpu_names():
    for package, name in list(RENAMED) + list(NOT_PORTED):
        assert name in PACKAGES[package], (package, name)
    for package in NOT_PORTED_PACKAGES:
        assert package in PACKAGES
        with pytest.raises(ImportError):
            importlib.import_module("lfdtpu_torch" + package[len("lfdtpu"):])
    assert all(NOT_PORTED.values()) and all(NOT_PORTED_PACKAGES.values())


def test_importing_the_package_imports_its_ops():
    """As `import lfdtpu` does, in a fresh process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    probe = "import sys, lfdtpu_torch; print('lfdtpu_torch.ops' in sys.modules)"
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "True"


# ------------------------------------------------------ lfd_resnet_output_info

def _plan(backbone):
    return dict(stem_mode=backbone.stem_mode, body_mode=backbone.body_mode,
                body_architecture=backbone.body_architecture,
                body_channels=backbone.body_channels, out_indices=backbone.out_indices)


@pytest.mark.parametrize("name", tuple(jax_zoo.ZOO))
def test_lfd_resnet_output_info_matches_lfdtpu_on_the_zoo(name):
    plan = _plan(jax_zoo.ZOO[name]().backbone)
    got = lfd_resnet_output_info(**plan)
    assert got == tuple(jax_output_info(**plan))
    built = torch_zoo.ZOO[name]().net._backbone
    assert got == (built.num_output_channels_list, built.num_output_strides_list)


TAPS_ONE = ((0, 1), (1, 0), (2, 0), (3, 0), (4, 0))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(stem_mode="faster"),
    dict(stem_mode="fastest", body_mode="fastest", out_indices=TAPS_ONE),
    dict(stem_mode="faster", body_mode="faster", out_indices=TAPS_ONE),
    dict(body_mode="faster", body_channels=(8, 16, 24, 32, 40), out_indices=((2, 0), (4, 0))),
    dict(body_mode=None, body_architecture=(2, 2, 1), body_channels=(16, 24, 32),
         out_indices=((1, 1), (0, 1), (2, 0))),
], ids=["defaults", "faster stem", "fastest", "faster", "channels", "plan, unsorted taps"])
def test_lfd_resnet_output_info_matches_lfdtpu_on_the_plans(kw):
    got = lfd_resnet_output_info(**kw)
    assert got == tuple(jax_output_info(**kw))
    built = LFDResNet(**kw)
    assert got == (built.num_output_channels_list, built.num_output_strides_list)


# ----------------------------------------------------------- bias_param_labels

def _lfd():
    _, variables, tdet = jax_and_port("WIDERFACE-L")
    return variables, tdet


def _lfdv2():
    _, variables, tdet = variant("TT100K-S", JLFDv2, LFDv2)
    return variables, tdet


def _fcos():
    _, variables, tdet = build_pair(head="fcos")
    return variables, tdet


@pytest.mark.parametrize("build", [_lfd, _lfdv2, _fcos], ids=["lfd", "lfdv2", "fcos"])
def test_bias_param_labels_match_lfdtpu_through_the_bridge(build):
    variables, tdet = build()
    labels = jax_bias_param_labels(variables["params"])
    marked = dict(variables)
    marked["params"] = jax.tree_util.tree_map(
        lambda label, leaf: np.full(np.shape(leaf), float(label == "bias"), np.float32),
        labels, variables["params"])
    marked["batch_stats"] = jax.tree_util.tree_map(
        lambda leaf: np.zeros(np.shape(leaf), np.float32), variables["batch_stats"])
    carried = jax_variables_to_state_dict(marked, tdet.net)
    got = bias_param_labels(tdet.net)
    assert list(got) == list(tdet.net.state_dict())
    n_bias = 0
    for name, t in tdet.net.state_dict().items():
        if not t.is_floating_point():
            assert got[name] == "other", name
            continue
        want = float(got[name] == "bias")
        assert torch.all(carried[name] == want), (name, got[name])
        n_bias += got[name] == "bias"
    assert n_bias > 0
    # bias_parameters is the "bias" group, each shared parameter once
    from lfdtpu_torch.execution.optim import bias_parameters

    group = bias_parameters(tdet.net)
    assert len({id(p) for p in group}) == len(group)
    assert {id(p) for p in group} == {id(m.bias) for m in tdet.net.modules()
                                      if isinstance(m, torch.nn.Conv2d) and m.bias is not None}
