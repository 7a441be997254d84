# Port models against lfdtpu: eval-mode dense outputs (cls, reg) of the
# WIDERFACE ZOO entries on the same weights and inputs, in fp32.
# Tolerance rtol=1e-4, atol=1e-5: the two frameworks sum the convs in a
# different order.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import jax_and_port

torch.set_num_threads(1)

NAMES = ("WIDERFACE-XS", "WIDERFACE-S", "WIDERFACE-M", "WIDERFACE-L")


def check_dense_outputs(name, hw):
    jdet, variables, tdet = jax_and_port(name)
    x = np.random.RandomState(hw[0] * 1000 + hw[1]).uniform(
        -1.0, 1.0, (2,) + hw + (3,)).astype(np.float32)
    jc, jr = jdet.net.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        tc, tr = tdet.net(torch.from_numpy(x))
    assert tc.shape == jc.shape and tr.shape == jr.shape
    assert tc.shape[1] == jdet.num_points(hw)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)])
@pytest.mark.parametrize("name", NAMES)
def test_dense_outputs_match_lfdtpu(name, hw):
    check_dense_outputs(name, hw)
