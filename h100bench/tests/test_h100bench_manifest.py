"""``BENCHMARK.json`` and the files it names, against the benchmark's
rules: names, units, the keys of each entry, the cells' chips, what each
cell reports, and a file for every configuration, cell, driver, reference
and per-layer metric."""

import json
import math
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "h100bench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(m["command"]) <= 32
    assert all(_line(w) for w in m["command"])
    for w in m["command"]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in m["paths"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = manifest()["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_keys_and_names():
    m = manifest()
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in m[section]]
        assert len(names) == len(set(names)), section
        for e in m[section]:
            assert set(e) - {"workloads"} == want, (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
    metric_names = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    assert 1 <= len(m["configs"]) <= 24
    assert 1 <= len(m["workloads"]) <= 24
    assert 1 <= len(m["end_to_end"]) <= 16
    assert 1 <= len(m["per_layer"]) <= 128


def test_configs():
    m = manifest()
    used = {w["config"] for w in m["workloads"]}
    files = set()
    for c in m["configs"]:
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or "hidden" in k
                       or k.endswith(("ch", "ch_mult", "channels"))
                       for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert data["compute_dtype"] in ("fp32", "bf16")
        assert os.path.exists(os.path.join(BENCH, "reference",
                                           f"{c['name']}.py"))


def test_workloads_and_cell_files():
    m = manifest()
    configs = {c["name"] for c in m["configs"]}
    pairs = set()
    for w in m["workloads"]:
        assert w["config"] in configs
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        assert _line(w["why"])
        with open(os.path.join(BENCH, "cells", f"{w['name']}.json")) as f:
            cell = json.load(f)
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert os.path.exists(os.path.join(BENCH, "drivers",
                                           f"{cell['driver']}.py"))
        assert cell["limits"] and all(
            v is not None and v >= 0 for v in cell["limits"].values())


def test_at_most_a_quarter_of_cells_on_four_chips():
    w = manifest()["workloads"]
    four = sum(1 for c in w if c["chips"] == 4)
    assert four <= max(1, len(w) // 4)


def test_metrics_units_sources_and_bounds():
    m = manifest()
    for e in m["end_to_end"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert m["end_to_end"][0]["name"] == "setup_s"
    assert any(e["name"] == "setup_s" and e["bound"] <= 0.25
               for e in m["end_to_end"])
    for e in m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(e["layer"])
        if e["name"].split(".")[0].endswith("_roofline") or \
                "mfu" in e["name"]:
            assert e["unit"] == "%"
        reader = [os.path.join(BENCH, "metrics", f"{b}.py")
                  for b in (e["name"], e["name"].split(".")[0])]
        assert any(os.path.exists(p) for p in reader), e["name"]


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    m = manifest()
    for w in m["workloads"]:
        e2e = [e for e in m["end_to_end"] if _reports(e, w["name"])]
        assert "setup_s" in [e["name"] for e in e2e]
        assert len(e2e) >= 2
        assert any(_reports(e, w["name"]) for e in m["per_layer"])


def test_each_layer_metric_moves_a_metric_its_cells_report():
    m = manifest()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    cells = [w["name"] for w in m["workloads"]]
    for e in m["per_layer"]:
        assert e["moves"] in e2e and e["moves"] != "setup_s"
        for c in e.get("workloads", cells):
            assert c in cells
            assert _reports(e2e[e["moves"]], c), (e["name"], c)


def test_a_layer_name_is_one_spelling():
    layers = {e["layer"] for e in manifest()["per_layer"]}
    assert {l.lower() for l in layers} == {l for l in layers}


@pytest.mark.parametrize("name", ["ok.name-1", "_x", "9lives"])
def test_name_rule_accepts(name):
    assert NAME.match(name)


@pytest.mark.parametrize("name", ["a b", "a,b", "a/b", ".x", "x" * 65])
def test_name_rule_refuses(name):
    assert not NAME.match(name)


def test_bounds_are_finite():
    for e in manifest()["end_to_end"]:
        assert math.isfinite(e["bound"])


def test_every_cell_file_names_a_configuration_driver_and_reference():
    """Cell files BENCHMARK.json does not list yet (a prepared cell) hold
    to the same names."""
    for f in os.listdir(os.path.join(BENCH, "cells")):
        with open(os.path.join(BENCH, "cells", f)) as fh:
            cell = json.load(fh)
        assert f == f"{cell['name']}.json" and NAME.match(cell["name"])
        for kind, name in (("configs", f"{cell['config']}.json"),
                           ("drivers", f"{cell['driver']}.py"),
                           ("reference", f"{cell['config']}.py")):
            assert os.path.exists(os.path.join(BENCH, kind, name))
        assert cell["limits"] and all(
            v is not None and v >= 0 for v in cell["limits"].values())
