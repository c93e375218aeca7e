"""BENCHMARK.json and the files it names: found by name, within the
contract's characters and limits, and in agreement with each other."""

import json
import re

import pytest

from benchmark import harness as H

ROOT = H.HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][1] == "benchmark/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in bench[group]]
        assert len(seen) == len(set(seen))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = ([w["why"] for w in bench["workloads"]]
             + [c["why"] for c in bench["configs"]]
             + [c["source"] for c in bench["configs"]]
             + [m["layer"] for m in bench["per_layer"]])
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)


def test_every_file_is_found_by_name(bench):
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for w in bench["workloads"]:
        wl = H.load_json("workloads", w["name"])
        assert {k: wl[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        H.load_json("traffic", w["traffic"])
        spec = H.cell_spec(w["name"])
        assert set(spec["limits"]) and all(
            v > 0 for v in spec["limits"].values())
    readers = H.load_readers()
    assert set(readers) == {m["name"] for m in bench["per_layer"]}
    for m in bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]


def test_metrics_cover_every_cell(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        traffic = H.load_json("traffic", w["traffic"])
        reported = [n for n, m in e2e.items()
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and traffic["metric"] in reported
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        assert all(c in moved.get("workloads", m["workloads"])
                   for c in m["workloads"])
