# K4's routes (ops/int8_conv.py::route_of) over the int8 chains of the zoo,
# read from each chain's static plan on the CPU: which hand-written kernel
# takes each conv on the card. The wgmma and stem routes must take every
# conv of every zoo chain; the plain mma.sync kernel keeps only the shapes the
# other two do not take, which no zoo chain has.
import collections

import pytest
import torch

from lfdtpu_torch import zoo
from lfdtpu_torch.deploy import int8_net
from lfdtpu_torch.ops import int8_conv as k4

torch.set_num_threads(1)


def chain_routes(name):
    """Counter of (route, (Cin, Cout, k, stride)) over the plan's K4 units."""
    det = zoo.ZOO[name]()
    chain = int8_net.Int8Chain(det.net, int8_net._EveryKey(), device="cpu")
    mods = dict(det.net.named_modules())
    shapes = [(mods[u.name].in_channels, u.wpack.shape[0], u.kernel_size, u.stride)
              for u in chain.units]
    assert len(shapes) == int8_net.planned_launches(det.net)
    return collections.Counter((k4.route_of(*s), s) for s in shapes)


@pytest.mark.parametrize("name,routes", [
    ("WIDERFACE-L", {"stem": 1, "wgmma": 31}), ("TL-L", {"stem": 1, "wgmma": 49}),
    ("WIDERFACE-S", {"stem": 1, "wgmma": 34}), ("WIDERFACE-M", {"stem": 1, "wgmma": 27}),
    ("TT100K-L", {"stem": 1, "wgmma": 33}), ("TT100K-S", {"stem": 1, "wgmma": 27}),
    ("WIDERFACE-XS", {"stem": 1, "wgmma": 34}), ("TL-S", {"stem": 1, "wgmma": 39}),
])
def test_zoo_int8_chains_by_route(name, routes):
    got = collections.Counter()
    for (route, (cin, cout, k, stride)), n in chain_routes(name).items():
        got[route] += n
        if route == "stem":
            assert cin == 3 and cout in (32, 48, 64) and (k, stride) == (3, 2)
        else:
            assert route == "wgmma"  # no zoo conv on the mma.sync route
            assert cin in (32, 48, 64, 128) and cout in (32, 48, 64, 128)
            assert k in (1, 3) and stride in (1, 2)
    assert dict(got) == routes


def test_route_of_takes_each_shape_once():
    assert k4.route_of(3, 64, 3, 2) == "stem"
    assert k4.route_of(3, 48, 3, 2) == "stem"  # TL-S's 48-channel stem
    assert k4.route_of(3, 32, 3, 2) == "stem"  # WIDERFACE-XS's 32-channel stem
    assert k4.route_of(3, 64, 3, 1) == k4.route_of(3, 16, 3, 2) == "mma"
    widths = (32, 48, 64, 128)
    assert {k4.route_of(ci, co, k, s) for ci in widths for co in widths
            for k in (1, 3) for s in (1, 2)} == {"wgmma"}
    assert k4.route_of(64, 96, 3, 1) == "mma"  # Cout 96
    assert k4.route_of(64, 64, 5, 1) == "mma"  # a 5x5
    assert k4.route_of(16, 32, 3, 1) == k4.route_of(32, 24, 1, 1) == "mma"
    assert k4.ROUTES == ("mma", "stem", "wgmma")  # the C entry point's numbers
    assert k4.int8_conv.routes.keys() == set(k4.ROUTES)


def test_cpu_tensors_take_no_route():
    """On the CPU the wrapper runs the plain version: no launch, no route."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (1, 9, 11, 64), generator=g).to(torch.int8)
    q, w_scale = k4.quantize_weights(torch.randn(64, 64, 3, 3, generator=g))
    wp = k4.pack_int8_weight(q)
    mult, bias = (w_scale * 1e-3).float(), torch.zeros(64)
    before = (k4.int8_conv.launches, dict(k4.int8_conv.routes))
    out = k4.int8_conv(x, wp, mult, bias, 3, 1, out_scale=0.05)
    assert torch.equal(out, k4.int8_conv_plain(x, wp, mult, bias, 3, 1, out_scale=0.05))
    assert (k4.int8_conv.launches, dict(k4.int8_conv.routes)) == before
