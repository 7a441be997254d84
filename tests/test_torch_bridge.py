# Weight bridge between lfdtpu (JAX) and lfdtpu_torch (PyTorch): JAX init ->
# numpy -> jax_convert -> port load_state_dict, and back through
# lfdtpu/execution/torch_convert.py, bit for bit, for every ZOO entry.
# Also home of the helpers the other test_torch_* files share.
import functools

import jax
import numpy as np
import pytest
import torch

from lfdtpu import zoo as jax_zoo
from lfdtpu.execution.torch_convert import convert_reference_state_dict
from lfdtpu_torch import zoo as torch_zoo
from lfdtpu_torch.execution.jax_convert import jax_variables_to_state_dict

torch.set_num_threads(1)

ZOO_NAMES = tuple(jax_zoo.ZOO)


def randomize_norms(variables, seed=0):
    """numpy copy of a JAX variables tree with non-trivial norm statistics,
    norm affines, biases and head Scales, so BN folding and the Scales are
    exercised (a fresh init has identity norms)."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            a = np.array(v, np.float32)
            if k == "mean":
                a = rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
            elif k == "var":
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k == "scale":
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k == "bias":
                a = (rng.randn(*a.shape) * 0.1).astype(np.float32)
            out[k] = a
        return out

    return walk(jax.device_get(variables))


@functools.cache
def jax_and_port(name, seed=0):
    """(JAX detector, its numpy variables, port detector with the same
    weights loaded, in eval mode). Cached: callers must not mutate them."""
    jdet = jax_zoo.ZOO[name]()
    variables = randomize_norms(jdet.init(jax.random.PRNGKey(seed), (64, 64)), seed)
    tdet = torch_zoo.ZOO[name]()
    tdet.net.load_state_dict(jax_variables_to_state_dict(variables, tdet.net),
                             strict=True)
    tdet.net.eval()
    return jdet, variables, tdet


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_bridge_round_trip_is_bit_exact(name):
    jdet, variables, tdet = jax_and_port(name)
    sd = {k: v.numpy() for k, v in tdet.net.state_dict().items()}
    back = convert_reference_state_dict(sd, jdet, variables)
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = np.asarray(flat_b[path])
        assert b.dtype == a.dtype and np.array_equal(a, b), path


def test_shared_head_registered_once_per_level():
    _, _, tdet = jax_and_port("WIDERFACE-L")
    head = tdet.net._head
    assert head.head1_merge_path is head.head0_merge_path
    sd = tdet.net.state_dict()
    assert "_head.head4_classification_path.0.weight" in sd
    assert "_head._scales.4._scale" in sd


def test_bridge_is_strict():
    jdet, variables, _ = jax_and_port("WIDERFACE-S")
    # an extra JAX leaf with no port counterpart
    extra = jax.tree.map(lambda a: a, variables)
    extra["params"]["head"]["scale9"] = {"scale": np.float32(1.0)}
    with pytest.raises(ValueError, match="unmapped JAX leaves"):
        jax_variables_to_state_dict(extra, torch_zoo.ZOO["WIDERFACE-S"]().net)
    # the wrong architecture (XS has 32-channel stems)
    with pytest.raises((ValueError, KeyError)):
        jax_variables_to_state_dict(variables, torch_zoo.ZOO["WIDERFACE-XS"]().net)
