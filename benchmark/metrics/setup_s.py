"""Set-up: the process's start to the first timed call, on the host clock."""


def read(run):
    return run.get("setup_s")
