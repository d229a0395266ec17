"""BENCHMARK.json keeps to the benchmark's contract, and every cell, metric
and configuration it names resolves to its files under benchmark/."""

import json
import re

import pytest

from benchmark.harness import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (cells.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
        assert (cells.ROOT / p).is_dir()
    for word in BENCH["command"]:
        assert _line(word)


def test_run_seconds_fits_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for path in (cells.BENCH_DIR).rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(cells.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and _line(cfg["source"]) and _line(cfg["why"])
    assert cfg["file"].startswith("benchmark/") and cfg["file"].endswith(".json")
    data = json.loads((cells.ROOT / cfg["file"]).read_text())
    assert isinstance(data, dict) and data["name"] == cfg["name"]
    assert cfg["reduced"] == data["reduced"] == []
    assert (cells.BENCH_DIR / "reference" / f"{data['reference']}.py").is_file()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def test_config_files_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_entry(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(wl["name"]) and NAME.match(wl["traffic"]) and _line(wl["why"])
    assert wl["name"] == f"{wl['config']}.{wl['traffic']}"
    assert wl["chips"] in (1, 4)
    assert (cells.BENCH_DIR / "traffic" / f"{wl['traffic']}.json").is_file()


def test_names_unique_and_four_chip_share():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert (cells.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for name in CELLS:
        cell = cells.resolve(BENCH, name)
        e2e = [m.name for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _line(m["layer"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
    assert (cells.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_layers_of_one_name_are_spelt_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"entry", "panel loop", "kernels", "device"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = cells.resolve(BENCH, name)
    assert cell.chips == 1
    assert callable(cell.entry.setup)
    for fn in ("make_victims", "judge", "shape"):
        assert callable(getattr(cell.reference, fn))
    assert set(cell.reference.LIMITS) and all(v == 0 for v in cell.reference.LIMITS.values())
    for key in ("entry", "loop", "clients", "outputs", "warmup", "trace_requests",
                "victims_per_s"):
        assert key in cell.traffic
    assert cell.traffic["loop"] == "closed" and cell.traffic["clients"] == 1
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.reader.read)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.resolve(BENCH, "no_such.cell")
