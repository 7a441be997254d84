"""Mean host ms of a predict-API call (pad, staging, engine, D2H, rows)."""

from benchmark.core import readers


def read(run):
    return readers.predict_ms(run)
