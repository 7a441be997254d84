"""Device ms a step of the NCCL kernels (the gradients' all-reduce and
sync-BN's collectives) on rank 0, profiled segment: the time they occupy,
much of it beside the backward's kernels."""


def read(run):
    seg = run.get("segment")
    if not seg or not seg["calls"]:
        return None
    return 1e3 * sum(v for k, v in seg["ops"].items() if "nccl" in k.lower()) / seg["calls"]
