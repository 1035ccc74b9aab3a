"""BENCHMARK.json against its contract: every file it names exists and
loads, names and units use the allowed characters, the readers are found
by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

from ucg_bench.gen import decks

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "steps_per_s", "block_ms_p95", "setup_s"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    assert NAME.match(cfg["name"])
    assert (ROOT / cfg["file"]).is_file()
    c = decks.load_config(cfg["name"])
    assert str(ROOT / cfg["file"]) == str(Path(c["_dir"]) / "config.json")
    assert c["reduced"] == cfg["reduced"] == []
    assert (Path(c["_dir"]) / c["template"]).is_file()
    assert (Path(c["_dir"]) / "limits.json").is_file()
    importlib.import_module(f"ucg_bench.roofline.{c['pair_style']}")
    for key in ("why", "source"):
        assert 1 <= len(cfg[key]) <= 200 and "\n" not in cfg[key]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200
    t = decks.load_traffic(cell["traffic"])
    assert {"n_atoms", "warmup_steps", "steps_per_s"} <= set(t)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    mod = importlib.import_module(f"ucg_bench.metrics.{metric['name']}")
    assert callable(mod.read)
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["per_layer"]:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    else:
        assert metric["source"] in ("device_trace", "host_clock")
        assert 0.01 <= metric["bound"] <= 0.25


def test_four_chip_share():
    four = [c for c in BENCH["workloads"] if c["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
