"""The port's entry points (gf2bv_tpu_torch/entry.py) against the JAX
package's ``__graft_entry__``, on the CPU: ``entry`` places the same padded
2048-column system and its step returns the same origin words and verdict;
``dryrun_multichip`` passes on meshes of 4 and 8 CPU shards and restores
``GF2BV_TPU_CPU_NATIVE``; both default to the card and raise without one."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from gf2bv_tpu_torch import torch_to_u32
from gf2bv_tpu_torch.entry import dryrun_multichip, entry
from gf2bv_tpu_torch.parallel import collectives

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def reference_entry():
    spec = importlib.util.spec_from_file_location("__graft_entry__",
                                                  REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    origin, unsat = fn(*args)
    return np.asarray(args[0]), np.asarray(origin), bool(unsat)


def test_entry_matches_reference(reference_entry):
    a_j, origin_j, unsat_j = reference_entry
    fn, (a,) = entry(device="cpu")
    assert a.device.type == "cpu" and np.array_equal(torch_to_u32(a), a_j)
    origin, unsat = fn(a)
    assert bool(unsat) == unsat_j is False
    assert np.array_equal(torch_to_u32(origin), origin_j)


@pytest.mark.parametrize("n_devices", [4, 8])
def test_dryrun_multichip(n_devices, monkeypatch):
    monkeypatch.setenv("GF2BV_TPU_CPU_NATIVE", "1")
    collectives.reset_counts()
    dryrun_multichip(n_devices, device="cpu")
    assert os.environ["GF2BV_TPU_CPU_NATIVE"] == "1"
    assert collectives.COUNTS["pmax"] == 3  # the three fused tournament solves
    monkeypatch.delenv("GF2BV_TPU_CPU_NATIVE")
    dryrun_multichip(n_devices, device="cpu")
    assert "GF2BV_TPU_CPU_NATIVE" not in os.environ


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card default")
@pytest.mark.parametrize("make", [lambda: entry(), lambda: dryrun_multichip(4)],
                         ids=["entry", "dryrun_multichip"])
def test_entry_points_default_to_the_card(make, monkeypatch):
    monkeypatch.setenv("GF2BV_TPU_CPU_NATIVE", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    assert os.environ["GF2BV_TPU_CPU_NATIVE"] == "1"
