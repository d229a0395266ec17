"""The plain references: victims as their generators make them, and judges
that count every wrong answer.  The program is imported here only to hold
the numpy SFMT against the port's own model (test side)."""

import json
import random

import numpy as np
import pytest

from benchmark.harness import cells, traffic

MT = cells.load_module("reference", "mt19937")
SF = cells.load_module("reference", "sfmt19937")
MT_CFG = cells.load_json(cells.BENCH_DIR / "configs" / "mt19937_bs32.json")
SF_CFG = cells.load_json(cells.BENCH_DIR / "configs" / "sfmt19937_low16.json")


@pytest.mark.parametrize("seed", [0, 1, 1234, 20260819, 2**32 - 1])
def test_numpy_sfmt_against_the_ports_model(seed):
    from gf2bv_tpu_torch.crypto.sfmt import SFMT19937

    st = SF.init_gen_rand([seed], SF_CFG)
    got = SF.draws(st, SF_CFG, 3 * 624 + 100)[0]
    g = SFMT19937.from_seed(seed)
    want = np.array([g() for _ in range(3 * 624 + 100)], dtype=np.uint32)
    assert (got == want).all()


def test_numpy_sfmt_against_the_published_output():
    # SFMT.19937.out.txt of the SFMT sources: init_gen_rand(1234), first 32-bit draws
    st = SF.init_gen_rand([1234], SF_CFG)
    assert SF.draws(st, SF_CFG, 5)[0].tolist() == [3440181298, 1564997079, 1510669302,
                                                    2930277156, 1452439940]


def test_sfmt_victims_are_many_at_once():
    seeds = traffic.victim_seeds(7, 0, 6)
    vs = SF.make_victims(SF_CFG, {"outputs": 2496}, seeds)
    one = SF.make_victims(SF_CFG, {"outputs": 2496}, seeds[3:4])[0]
    assert vs[3].observed == one.observed and (vs[3].future == one.future).all()
    assert all(len(v.observed) == 2496 and max(v.observed) < 2**16 for v in vs)
    assert len({tuple(v.observed[:8]) for v in vs}) == 6


def _sfmt_state(seed):
    st = SF.init_gen_rand([seed], SF_CFG)
    for _ in range(SF_CFG["burn"] // 624):
        SF.gen_block(st, SF_CFG)
    return [int(x) for x in st[0]]


def test_sfmt_judge():
    seeds = traffic.victim_seeds(11, 0, 3)
    mix = {"outputs": 2496}
    vs = SF.make_victims(SF_CFG, mix, seeds)
    right = [_sfmt_state(int(s)) for s in seeds]
    assert SF.judge(SF_CFG, mix, vs, right) == {"wrong_leaks": 0, "wrong_future": 0}
    wrong = [list(a) for a in right]
    wrong[1][5] ^= 1 << 7
    one = SF.judge(SF_CFG, mix, vs[1:2], [tuple(wrong[1])])
    assert 0 < one["wrong_leaks"] < 2496 and 0 < one["wrong_future"] <= 1000
    got = SF.judge(SF_CFG, mix, vs, [right[0], tuple(wrong[1]), None])
    assert got == {"wrong_leaks": one["wrong_leaks"] + 2496,
                   "wrong_future": one["wrong_future"] + 1000}
    for bad in (right[0][:-1], right[0][:-1] + [2**32]):
        assert SF.judge(SF_CFG, mix, vs[:1], [bad]) == {"wrong_leaks": 2496,
                                                        "wrong_future": 1000}


def test_mt_victims_are_cpythons():
    seeds = traffic.victim_seeds(3, 0, 4)
    vs = MT.make_victims(MT_CFG, {"outputs": 624}, seeds)
    for s, v in zip(seeds, vs):
        r = random.Random(int(s))
        assert v.state == tuple(r.getstate()[1][:624])
        assert v.observed == [r.getrandbits(32) for _ in range(624)]


def test_mt_judge():
    vs = MT.make_victims(MT_CFG, {"outputs": 624}, traffic.victim_seeds(5, 0, 3))
    right = [v.state for v in vs]
    assert MT.judge(MT_CFG, {}, vs, right) == {"wrong_words": 0}
    flipped = list(right[2])
    flipped[100] ^= 1
    assert MT.judge(MT_CFG, {}, vs, [right[0], None, tuple(flipped)]) == {"wrong_words": 625}
    assert MT.judge(MT_CFG, {}, vs[:1], [right[0][:600]])["wrong_words"] == 624


def test_shapes():
    assert MT.shape(MT_CFG, {"outputs": 624}) == {"rows": 20000, "cols": 19968}
    assert MT.shape(MT_CFG, {"outputs": 2100}) == {"rows": 67232, "cols": 19968}
    assert SF.shape(SF_CFG, {"outputs": 2496}) == {"rows": 39936, "cols": 19968}


def test_victim_seeds_distinct_and_deterministic():
    a = traffic.victim_seeds(2**31 + 12345, 0, 5000)
    assert len(set(a.tolist())) == 5000 and a.max() < 2**32
    assert (traffic.victim_seeds(2**31 + 12345, 100, 10) == a[100:110]).all()
    assert not (traffic.victim_seeds(2**31 + 12346, 0, 10) == a[:10]).all()
    assert traffic.victim_seeds(-7, 0, 3).shape == (3,)


def test_mix_files_parse():
    for path in sorted((cells.BENCH_DIR / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        assert mix["outputs"] > 0 and mix["trace_requests"] > 0
