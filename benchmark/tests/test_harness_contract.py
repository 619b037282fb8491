"""``BENCHMARK.json`` against the contract's form, and against the files
the harness finds by name."""

import ast
import json
import re

import pytest

from benchmark import harness
from benchmark.tests.conftest import ALL

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("bench", [BENCH, ALL],
                         ids=["benchmark", "with_waiting"])
def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] \
        + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]] \
        + [w["traffic"] for w in bench["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads"):
        got = [x["name"] for x in bench[kind]]
        assert len(got) == len(set(got))
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("bench", [BENCH, ALL],
                         ids=["benchmark", "with_waiting"])
def test_entries_have_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _one_line(m["layer"])


@pytest.mark.parametrize("bench", [BENCH, ALL],
                         ids=["benchmark", "with_waiting"])
def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in bench["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and per


@pytest.mark.parametrize("bench", [BENCH, ALL],
                         ids=["benchmark", "with_waiting"])
def test_moves_is_reported_by_every_cell_of_the_metric(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in target.get("workloads", [cell]), (m["name"], cell)


@pytest.mark.parametrize("bench", [BENCH, ALL],
                         ids=["benchmark", "with_waiting"])
def test_files_found_by_name_agree(bench):
    """Each config, mix, entry and metric is a file of its own, and each
    metric file declares the layer, unit and ``moves`` the JSON gives."""
    for w in bench["workloads"]:
        mix = json.loads((ROOT / "benchmark" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "entries" / f"{mix['entry']}.py").is_file()
        assert set(mix["check"]["limits"])
    for m in bench["end_to_end"]:
        assert (ROOT / "benchmark" / "end_to_end" / f"{m['name']}.py").is_file()
    for m in bench["per_layer"]:
        src = (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").read_text()
        decl = {}
        for node in ast.parse(src).body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.targets[0], ast.Name) and \
                    node.targets[0].id in ("LAYER", "UNIT", "MOVES"):
                decl[node.targets[0].id] = ast.literal_eval(node.value)
        assert decl == {"LAYER": m["layer"], "UNIT": m["unit"],
                        "MOVES": m["moves"]}, m["name"]


@pytest.mark.parametrize("bench", [BENCH, ALL],
                         ids=["benchmark", "with_waiting"])
def test_layers_are_spelled_alike(bench):
    by_layer = {}
    for m in bench["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_config_files_hold_every_key_of_the_port_config():
    import dataclasses

    from ocdp_tpu_torch.models import attitude, pos_att

    classes = {"ocdp_tpu_torch.models.pos_att.PosAttConfig":
               pos_att.PosAttConfig,
               "ocdp_tpu_torch.models.attitude.AttitudeConfig":
               attitude.AttitudeConfig}
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        cls = classes[conf["class"]]
        assert set(conf["params"]) == {f.name for f in
                                       dataclasses.fields(cls)}
        assert conf["reduced"] == c["reduced"] == []
        assert conf["source"] == c["source"] and conf["chips"] == 1


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_load_cell(cell):
    c = harness.load_cell(cell, device="cpu", bench=ALL)
    assert c.chips == 1 and c.mix["check"]["sample"] >= 1


def test_waiting_cells_are_not_in_the_benchmark():
    names = {w["name"] for w in BENCH["workloads"]}
    for f in (ROOT / "benchmark" / "waiting").glob("*.json"):
        w = json.loads(f.read_text())
        assert set(w) == {"why", "workloads", "end_to_end", "per_layer"}
        assert _one_line(w["why"])
        assert not names & {x["name"] for x in w["workloads"]}
