"""Frames whose rows reached the host, over the window's wall time."""


def read(run):
    return len(run["done"]) / run["done"][-1] if run.get("done") else None
