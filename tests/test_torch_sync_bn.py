# Sync-BN of the port (models/layers.py::BatchNorm2d with a data mesh
# attached by parallel.sync_batchnorm) on the CPU, two processes over gloo,
# in float64: the ranks' forward outputs, input gradients, the sum of their
# affine gradients and their running_mean / running_var equal one process's
# port BatchNorm2d on the concatenated batch (rtol 1e-10), at 5x6 maps, at a
# 1x1 level with 2 rows a rank (the shape where E[x^2] - E[x]^2 loses the
# most, ROADMAP F8) and with 1 and 3 rows on the two ranks; an eval-mode
# layer with a mesh attached makes no collective. At world size 1 the layer
# is bit-equal to the layer without a mesh; the state_dict keeps its names.
import copy
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import join_group, run_ranks

torch.set_num_threads(1)

TOL = 1e-10
C = 4
SHAPES = {  # name: (rank 0's input shape, rank 1's)
    "5x6": ((3, C, 5, 6), (3, C, 5, 6)),
    "1x1_level": ((2, C, 1, 1), (2, C, 1, 1)),
    "uneven_rows": ((1, C, 1, 1), (3, C, 1, 1)),
}


def layer(seed=0):
    """A port BatchNorm2d with seeded affines and running statistics."""
    from lfdtpu_torch.models.layers import BatchNorm2d

    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm2d(C, eps=1e-5, momentum=0.1).double()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=g, dtype=torch.float64) + 0.5)
        bn.bias.copy_(torch.randn(C, generator=g, dtype=torch.float64) * 0.1)
        bn.running_mean.copy_(torch.randn(C, generator=g, dtype=torch.float64) * 0.1)
        bn.running_var.copy_(torch.rand(C, generator=g, dtype=torch.float64) + 0.5)
    return bn


def inputs(name):
    """Each rank's input (an offset mean, so E[x^2] and E[x]^2 are close)
    and the upstream gradient, seeded."""
    rng = np.random.RandomState(11)
    out = []
    for shape in SHAPES[name]:
        x = rng.normal(3.0, 0.5, shape)
        out.append((torch.from_numpy(x), torch.from_numpy(rng.normal(size=shape))))
    return out


def run_layer(bn, x, g):
    """y, dL/dx, dL/dweight, dL/dbias and the running stats of one training
    forward and backward of L = sum(y * g)."""
    x = x.clone().requires_grad_(True)
    bn.train()
    y = bn(x)
    (y * g).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dw=bn.weight.grad, db=bn.bias.grad,
                mean=bn.running_mean.clone(), var=bn.running_var.clone(),
                tracked=int(bn.num_batches_tracked))


def worker(rank, world, port, job_path, out_dir):
    import torch.distributed as dist

    from lfdtpu_torch.parallel import make_mesh, sync_batchnorm

    join_group(rank, world, port)
    rank = int(rank)
    mesh = make_mesh("cpu")
    out = {}
    for name in SHAPES:
        bn = sync_batchnorm(layer(), mesh)
        out[name] = run_layer(bn, *inputs(name)[rank])
    # a frozen (eval-mode) layer with the mesh attached makes no collective:
    # only rank 0 runs it, then one all-reduce must pair the two ranks
    if rank == 0:
        sync_batchnorm(layer(), mesh).eval()(inputs("5x6")[0][0])
    t = torch.tensor([float(rank + 1)], dtype=torch.float64)
    dist.all_reduce(t)
    out["paired"] = float(t)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync_bn")
    return run_ranks("test_torch_sync_bn", "-", tmp)


@pytest.mark.parametrize("name", list(SHAPES))
def test_two_ranks_equal_one_process_on_the_global_batch(ranks, name):
    parts = inputs(name)
    ref = run_layer(layer(), torch.cat([x for x, _ in parts]), torch.cat([g for _, g in parts]))
    rows = [x.shape[0] for x, _ in parts]
    lo = 0
    for r, n in enumerate(rows):
        got = ranks[r][name]
        for k in ("y", "dx"):
            np.testing.assert_allclose(got[k].numpy(), ref[k][lo:lo + n].numpy(), rtol=TOL,
                                       atol=TOL, err_msg=f"rank {r} {k}")
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} running_{k}")
        assert got["tracked"] == ref["tracked"] == 1
        lo += n
    for k in ("dw", "db"):  # each rank holds its rows' share; DDP sums them
        np.testing.assert_allclose((ranks[0][name][k] + ranks[1][name][k]).numpy(),
                                   ref[k].numpy(), rtol=TOL, atol=TOL, err_msg=k)
    # the biased variance of the global batch went into running_var (F5)
    x = torch.cat([x for x, _ in parts])
    want = 0.9 * layer().running_var + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(ranks[0][name]["var"].numpy(), want.numpy(), rtol=TOL)


def test_eval_mode_makes_no_collective(ranks):
    assert ranks[0]["paired"] == ranks[1]["paired"] == 3.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_world_size_1_is_bit_equal_to_the_layer_without_a_mesh(dtype):
    from lfdtpu_torch.parallel import Mesh, sync_batchnorm

    x, g = inputs("1x1_level")[0]
    x, g = x.to(dtype), g.to(dtype)
    plain, synced = layer().to(dtype), sync_batchnorm(layer().to(dtype),
                                                      Mesh(1, 0, torch.device("cpu")))
    assert synced.mesh.size == 1 and plain.mesh is None
    a, b = run_layer(plain, x, g), run_layer(synced, x, g)
    for k in a:
        assert (a[k] == b[k]) if k == "tracked" else torch.equal(a[k], b[k]), k


def test_sync_batchnorm_keeps_the_state_dict_and_copies():
    from lfdtpu_torch import zoo
    from lfdtpu_torch.models.layers import BatchNorm2d
    from lfdtpu_torch.parallel import Mesh, sync_batchnorm

    net = zoo.widerface_lfd("XS").net
    keys = list(net.state_dict())
    mesh = Mesh(2, 0, torch.device("cpu"))
    sync_batchnorm(net, mesh)
    bns = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    assert bns and all(m.mesh is mesh for m in bns)
    assert list(net.state_dict()) == keys
    assert all(m.mesh is mesh for m in copy.deepcopy(net).modules()
               if isinstance(m, BatchNorm2d))  # an engine's copy shares the handle


if __name__ == "__main__" and len(sys.argv) > 1:
    worker(*sys.argv[1:])
