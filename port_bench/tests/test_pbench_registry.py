"""Every piece of every cell is found by its name, and BENCHMARK.json keeps
to the benchmark's contract (names, units, keys, bounds, limits)."""

import json
import re

import pytest

import pbench_tiny  # noqa: F401  (puts the checkout on sys.path)
from port_bench.core import registry

BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert (registry.ROOT / BENCH["command"][1]).is_file()
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_found_by_name(cell):
    c = registry.Cell(cell)
    assert c.config["name"] == c.entry["config"]
    driver = registry.load_driver(c.traffic["driver"])
    assert callable(driver.run) and callable(driver.readings)
    assert c.limits, "a cell's comparison has limits"
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert c.chips == 1


@pytest.mark.parametrize("config", [c["file"] for c in BENCH["configs"]])
def test_family_found_by_name(config):
    """A configuration's family names how its program is built and its plain
    reference, each a file of its own."""
    from port_bench.reference import model as ref_model

    cfg = json.loads((registry.ROOT / config).read_text())
    assert callable(registry.load_program(cfg["family"]).model)
    family = ref_model.family(cfg)
    assert callable(family.param_spec) and callable(family.forward)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    assert callable(registry.load_metric(metric))


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
        cfg = json.loads((registry.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= ({"bound"} if m in BENCH["end_to_end"]
                    else {"layer", "moves"})
        assert set(m) <= allowed and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        reporting = {w["name"] for w in BENCH["workloads"]
                     if any(e["name"] == m["moves"]
                            and w["name"] in e.get("workloads", [w["name"]])
                            for e in BENCH["end_to_end"])}
        assert set(m["workloads"]) <= reporting
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_every_config_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
