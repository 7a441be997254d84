"""On the card only: one short run of each cell through benchmark/run.py,
as a check runs it, with its result line read back. Skips where torch
sees no CUDA device (decided inside the test).

    python -m pytest -q -m cuda benchmark/tests/test_bench_cuda.py
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.core import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_a_short_run_on_the_card_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card only")
    out = subprocess.run([sys.executable, str(spec.BENCH / "run.py"), "--workload", name,
                          "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu"
