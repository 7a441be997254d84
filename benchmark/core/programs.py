"""The program's entry points that the cells added after system.py need:
FCOS-R50-FPN from the port's zoo, and the data-parallel train step over a
process group. With system.py and spans.py the modules of the harness that
import the program, and for them only.
"""

from __future__ import annotations


def fcos_detector(weights):
    """The port's FCOS-R50-FPN (zoo.fcos_r50_fpn) with `weights` (the
    reference's names are the program's own) loaded strictly; a program
    without it raises."""
    from lfdtpu_torch import zoo

    det = zoo.fcos_r50_fpn()
    det.net.load_state_dict(weights, strict=True)
    return det


def mesh(device):
    """The data mesh over the initialized process group (parallel.make_mesh)."""
    from lfdtpu_torch.parallel import make_mesh

    return make_mesh(device)


def ddp_train_step(det, cfg, mesh_):
    """(net, optimizer, step) of the configuration's train step over the
    mesh: create_train_state(mesh=) (every rank starts from rank 0's
    weights) and make_train_step(mesh=) (sync-BN, global loss normalizers,
    DistributedDataParallel's all-reduce), with the workload's optimizer,
    clip, device normalize and precision."""
    from lfdtpu_torch.deploy import make_device_preprocess
    from lfdtpu_torch.execution import SGD
    from lfdtpu_torch.parallel import create_train_state, make_train_step

    t, s = cfg["train"], cfg["serve"]
    o = t["optimizer"]
    state = create_train_state(det, SGD(momentum=o["momentum"], weight_decay=o["weight_decay"]),
                               mesh=mesh_)
    step = make_train_step(det, state.optimizer, t["crop"], clip_max_norm=t["clip_max_norm"],
                           preprocess=make_device_preprocess(s["mean"], s["std"]),
                           mixed_precision=t["mixed_precision"], mesh=mesh_)
    return state.net, state.optimizer, step
