"""BENCHMARK.json against the contract it is checked by: names, units and
lengths; every file a name points to; which metrics each cell reports; the
rule on four-chip cells; the time a full check of 24 cells takes."""

import json
import math
import re

import pytest

from perfbench.tests import cases

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)_size"
                   r"|(_dim|_rank)$|expand|experts_per_tok|kv_channels"
                   r"|group_num")


@pytest.fixture(scope="module")
def bench():
    return cases.bench()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    for word in bench["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_entries(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    groups = [bench["configs"], bench["workloads"], metrics]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in bench["end_to_end"])


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        body = json.loads((cases.ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]


def test_every_name_has_its_files(bench):
    root = cases.ROOT / "perfbench"
    for w in bench["workloads"]:
        assert (root / "traffic" / f"{w['traffic']}.json").is_file()
        assert (root / "limits" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (root / "metrics" / f"{m['name']}.py").is_file()


def _reported(bench, metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_each_cell_reports_what_the_contract_asks(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    for cell in cells:
        names = [n for n, m in e2e.items() if _reported(bench, m, cell)]
        assert "setup_s" in names and len(names) >= 2
        assert any(_reported(bench, m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", moved.get("workloads", cells)):
            assert _reported(bench, moved, cell), (m["name"], cell)


def test_layers_are_named_alike(bench):
    """A layer's metrics give it the same name, one line each."""
    by_module = {}
    for m in bench["per_layer"]:
        by_module.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


def test_four_chip_cells(bench):
    n4 = sum(w["chips"] == 4 for w in bench["workloads"])
    assert n4 <= max(1, math.floor(0.25 * len(bench["workloads"])))


def test_a_full_check_of_24_cells_fits(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
