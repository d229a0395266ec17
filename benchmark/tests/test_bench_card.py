"""On the card: a run prints the contract's result line last, and the
numbers compared last on standard error."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import cells

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("traced", [0, 1])
def test_result_line(card, traced):
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mt19937_bs32.single624",
         "--seed", str(2**31 + 99), "--seconds", "3", "--trace", str(traced)],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=1200, env=dict(os.environ))
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    cell = cells.resolve(cells.load_benchmark(), "mt19937_bs32.single624")
    want = cell.per_layer if traced else cell.end_to_end
    assert set(out["metrics"]) == {m.name for m in want}
    if traced:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert out["metrics"]["elimination_roofline"]["value"] < 100
        assert len(out["breakdown"]["device_ops"]) <= 10
    tail = res.stderr.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in tail)
