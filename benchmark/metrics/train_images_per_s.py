"""Images trained on, over the window's wall time."""


def read(run):
    return run["items_per_call"] * len(run["step_ends"]) / run["step_ends"][-1] if run.get("step_ends") else None
