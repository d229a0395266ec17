"""A run of each cell on the CPU, past the harness's look for a card: sound,
it comes out correct; with the control, or with the timed path broken
underneath, it comes out not correct.

The faults a cell of single requests on one chip can have: a step that
returns its state unchanged (the elimination hands back its input), and an
answer altered where it is produced.  No cell has a batch or an exchange
between chips.  The MT19937 cells run the port's plain PyTorch twins on the
CPU (about half a minute a solve); where a test needs only the harness and
the judge, an oracle stands in for the elimination.
"""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import cells, core, traffic

SEED = 2**31 + 77
CELLS = ["mt19937_bs32.single624", "sfmt19937_low16.single2496", "mt19937_bs32.single2100"]
MT_CELLS = [c for c in CELLS if c.startswith("mt19937")]


def _cell(name, **mix):
    cell = cells.resolve(cells.load_benchmark(), name)
    cell.traffic = {**cell.traffic, "warmup": 0, **mix}
    return cell


def _run(cell, traced=False, control=False):
    """One request on the CPU (a window of 0 s serves one)."""
    result, numbers = core.run_cell(cell, SEED, 0.0, traced, "cpu", time.perf_counter(),
                                    control=control)
    assert list(result)[-1] == "checks"
    return result, numbers


def _states(cell, count=4):
    seeds = traffic.victim_seeds(SEED, 0, count)
    return [v.state for v in cell.reference.make_victims(cell.config, cell.traffic, seeds)]


@pytest.fixture
def oracle(monkeypatch):
    """The MT elimination replaced by the victims' true states in order."""
    from gf2bv_tpu_torch.ops import gauss_blocked

    def install(cell):
        states = iter(_states(cell))

        def solve_on_device(a, cols, mode, *args, **kwargs):
            s = sum(int(w) << (32 * i) for i, w in enumerate(next(states)))
            return np.frombuffer(s.to_bytes(624 * 4, "little"), dtype="<u8").copy()

        monkeypatch.setattr(gauss_blocked, "solve_on_device", solve_on_device)

    return install


def test_sound_sfmt_run_is_correct():
    result, numbers = _run(_cell("sfmt19937_low16.single2496"))
    assert result["correct"] and result["attempted"] == 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"recoveries_per_s", "solve_p95_ms", "setup_s"}
    assert all(v == (0, 0) for v in numbers.values())


def test_sound_sfmt_traced_run_is_correct():
    result, _ = _run(_cell("sfmt19937_low16.single2496", trace_requests=2), traced=True)
    assert result["correct"] and result["attempted"] == 2
    assert "entry_host_ms" in result["metrics"] and "launches_per_solve" in result["metrics"]
    # nothing ran on a device: no device metric is made up
    assert "device_ms" not in result["metrics"] and "elimination_roofline" not in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_sound_mt_run_is_correct():
    """The full flagship solve through the port's CPU twins."""
    result, numbers = _run(_cell("mt19937_bs32.single624"))
    assert result["correct"], result
    assert numbers == {"wrong_words": (0, 0)}


@pytest.mark.parametrize("name", MT_CELLS)
def test_oracle_mt_run_is_correct(name, oracle):
    cell = _cell(name)
    oracle(cell)
    assert _run(cell)[0]["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    result, numbers = _run(_cell(name), control=True)
    assert not result["correct"]
    assert any(v > lim for v, lim in numbers.values()), numbers


@pytest.mark.parametrize("name", CELLS)
def test_step_returning_its_state_unchanged_is_not_correct(name, monkeypatch):
    from gf2bv_tpu_torch.ops import gauss_blocked

    def unchanged(a, cols, k_panel=256, trailing=False, **kwargs):
        return a, torch.full((cols,), -1, dtype=torch.int32), torch.tensor(False)

    monkeypatch.setenv("GF2BV_TPU_CPU_NATIVE", "0")  # the captured model on the blocked path
    monkeypatch.setattr(gauss_blocked, "rref_blocked", unchanged)
    cell = _cell(name)
    result, numbers = _run(cell)
    assert not result["correct"] and result["failed"] == 0
    # no solution found: every word, leak and draw of the request is wrong
    if name.startswith("mt19937"):
        assert numbers == {"wrong_words": (624, 0)}
    else:
        assert numbers == {"wrong_leaks": (2496, 0), "wrong_future": (1000, 0)}


@pytest.mark.parametrize("name", MT_CELLS)
def test_mt_answer_altered_where_produced_is_not_correct(name, oracle, monkeypatch):
    from gf2bv_tpu_torch.crypto import mt_torch

    produce = mt_torch._state_words

    def altered(origin):
        words = list(produce(origin))
        words[5] ^= 1 << 9
        return tuple(words)

    cell = _cell(name)
    oracle(cell)
    monkeypatch.setattr(mt_torch, "_state_words", altered)
    result, numbers = _run(cell)
    assert not result["correct"] and numbers["wrong_words"] == (1, 0)


def test_sfmt_answer_altered_where_produced_is_not_correct(monkeypatch):
    from gf2bv_tpu_torch.core.system import LinearSystem

    produce = LinearSystem.convert_sol

    def altered(self, s):
        words = list(produce(self, s))
        words[5] ^= 1 << 9
        return tuple(words)

    monkeypatch.setattr(LinearSystem, "convert_sol", altered)
    result, numbers = _run(_cell("sfmt19937_low16.single2496"))
    assert not result["correct"] and numbers["wrong_future"][0] > 0


def test_a_request_that_raises_is_a_failure(monkeypatch):
    cell = _cell("sfmt19937_low16.single2496")
    real = cell.entry.setup

    def broken_setup(*args, **kwargs):
        real(*args, **kwargs)

        def solve(observed):
            raise RuntimeError("launch failed")

        return solve

    monkeypatch.setattr(cell.entry, "setup", broken_setup)
    result, _ = _run(cell)
    assert not result["correct"] and result["failed"] == 1
