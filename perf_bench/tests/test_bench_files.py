"""Every cell, configuration, traffic mix, driver and metric is found by its
name, and a new cell or metric is one new file the harness finds unedited."""
import importlib.util
import json
import shutil
import time

import pytest
from conftest import ROOT

from perf_bench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = harness.load_cell(cell)
    assert c["config"] == entry["config"] and c["traffic"] == entry["traffic"]
    assert c["chips"] == entry["chips"]
    driver = harness.load_module("drivers", c["driver"])
    assert callable(driver.run) and driver.KIND in ("rollout", "train")
    conf = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert (ROOT / conf["file"]).resolve() == harness.HERE / "configs" / f"{c['config']}.json"
    assert driver.KIND in c["config_spec"]["checks"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    mod = harness.load_module("metrics", metric)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert mod.UNIT == entry["unit"]
    assert mod.read({}) is None  # nothing to read: no number, never 0


def test_every_metric_file_is_in_the_benchmark():
    assert set(harness.metric_names()) == {m["name"] for m in BENCH["per_layer"]}


def test_a_new_cell_and_metric_are_files_alone(tmp_path):
    """A copy of the harness finds a dummy cell, driver and metric that were
    only added as files, and reports the metric in a traced run."""
    copy = tmp_path / "perf_bench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (copy / "workloads" / "dummy_cell.json").write_text(json.dumps(
        {"config": "gym", "traffic": "sessions96_ctx62_heun64", "driver": "dummy", "chips": 1}))
    (copy / "drivers" / "dummy.py").write_text(
        "KIND = 'dummy'\n"
        "def run(cell, seed, seconds, trace, device, t0):\n"
        "    return {'kind': 'dummy', 'setup_s': 1.0, 'attempted': 3, 'failed': 0,\n"
        "            'e2e': {'dummy_rate': (2.0, 'items/s')}, 'memory_peak_bytes': 0,\n"
        "            'checks': [('dummy_gap', 0.1, 0.5)], 'trace': {'busy_s': 1.0,\n"
        "            'window_s': 2.0, 'device_ops': [], 'idle_gaps': []}}\n")
    (copy / "metrics" / "dummy_metric.py").write_text(
        "UNIT = 'items'\n"
        "def read(rec):\n"
        "    return 7.0 if rec.get('kind') == 'dummy' else None\n")
    spec = importlib.util.spec_from_file_location("harness_copy", copy / "harness.py")
    h = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(h)
    cell = h.load_cell("dummy_cell")
    traced = h.measure(cell, 1, 1, True, "cpu", time.perf_counter())
    assert traced["metrics"] == {"dummy_metric": {"value": 7.0, "unit": "items"}}
    plain = h.measure(cell, 1, 1, False, "cpu", time.perf_counter())
    assert set(plain["metrics"]) == {"dummy_rate", "setup_s"}
    assert plain["correct"] and list(plain)[-1] == "checks"


def test_configurations_name_every_cut():
    for conf in BENCH["configs"]:
        spec = json.loads((ROOT / conf["file"]).read_text())
        assert spec["reduced"] == conf["reduced"]
        assert spec["source"] == conf["source"]
