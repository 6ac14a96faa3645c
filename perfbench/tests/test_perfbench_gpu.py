"""Each cell run on the card through its command line, a short window
without and with the trace: `correct`, every metric the cell lists, no
null, and the trace's hand-kernel events equal to the program's launch
counters. Skips without a CUDA device.

    python -m pytest perfbench/tests/test_perfbench_gpu.py -m gpu
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")
         ["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cuda, name, trace):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         "3000000001", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.Cell(name).metrics[kind]}
    assert set(res["metrics"]) == want
    assert all(m["value"] is not None for m in res["metrics"].values())
    if trace:
        assert res["trace_kernel_events"] == res["launch_counts"]
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
