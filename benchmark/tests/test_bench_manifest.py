"""BENCHMARK.json against the contract's shape, and every cell's files found
by name."""

import json
import re

import pytest

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = core.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                  for p in MAN["paths"])
    assert len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_their_keys_and_names(section):
    entries = MAN[section]
    assert entries and len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_names_of_traffic_and_reduced():
    for w in MAN["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {c["name"] for c in MAN["configs"]} == {w["config"] for w in MAN["workloads"]}


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert m["moves"] in [x["name"] for x in core.metrics_of(MAN, cell)["end_to_end"]]
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_check_fits_the_day():
    """2 + 14 runs a cell at run_seconds + 60 s, 2 x 90 s a cell to
    compile and 1200 s spare, for the full 24 cells, within 43200 s."""
    n = 24
    assert (2 + 14 * n) * (MAN["run_seconds"] + 60) + n * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    files = core.cell_files(MAN, cell)
    assert files["traffic"].is_file()
    wanted = core.metrics_of(MAN, cell)
    names = [m["name"] for m in wanted["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert wanted["per_layer"], cell
    for m in wanted["per_layer"]:
        assert (core.BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert _line(files["cell"]["why"]) and files["cell"]["why"] == files["entry"]["why"]
    assert set(files["cell"]["limits"]) and all(v > 0 for v in files["cell"]["limits"].values())


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_file_is_what_runs(config):
    entry = {c["name"]: c for c in MAN["configs"]}[config]
    assert entry["file"].startswith(MAN["paths"][0] + "/")
    data = core.load_json(core.ROOT / entry["file"])
    assert data["name"] == config and data["reduced"] == entry["reduced"]
    assert data["source"] == entry["source"]
    core.program_config(data)  # raises where the program would run another number
