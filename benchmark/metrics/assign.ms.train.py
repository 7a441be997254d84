"""ms of the port's target assignment alone on the cell's batches (CUDA events)."""


def read(run):
    return run.get("assign_ms")
