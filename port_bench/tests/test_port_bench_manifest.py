"""The manifest and every file it names keep to the benchmark's contract, and
the harness finds its files by name (a later cell, configuration, traffic
mix or metric is new files and entries only)."""

import json
import os
import re
import shutil

import pytest

from port_bench import manifest
from port_bench.tests import checks

ROOT = manifest.ROOT
MAN = manifest.load_manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(MAN) == TOP_KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(checks.LINE.match(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w == p or w.startswith(p + "/") for p in MAN["paths"]), w


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(checks.NAME.match(n) for n in names)


def test_configs():
    checks.check_configs(MAN, manifest.HERE)


def test_workloads():
    checks.check_workloads(MAN, manifest.HERE)


def test_metrics():
    checks.check_metrics(MAN, manifest.HERE)
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for layer in {m["layer"] for m in MAN["per_layer"]}:
        assert layer in perf, layer


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    checks.check_reports(MAN)


def test_bad_names_are_refused():
    for bad in ("../x", "a/b", "a b", ""):
        with pytest.raises(ValueError):
            manifest.reader(bad)
        with pytest.raises(ValueError):
            manifest.traffic(bad)
        with pytest.raises(ValueError):
            manifest.entry(bad)


def test_a_configuration_without_an_entry_runs_the_fit_harness(monkeypatch):
    from port_bench import harness, run

    assert manifest.entry_name({}) == "fit"
    assert all("entry" not in manifest.config(n) for n in ("flagship_2160p", "frag_gs_v10_2160p"))
    seen = []

    def stub(cfg, traffic, limits, seed, seconds, trace, device, t_start, readers, names):
        seen.append(cfg["traj"])
        return {"fit_ms_per_step": 2.0, "setup_s": 1.0, "steps": 3, "memory_peak_bytes": 0, "events": [],
                "capacity": 1, "alive_at_start": 1, "phases": {}, "check": []}

    monkeypatch.setattr(harness, "run_cell", stub)
    res, _ = run.result(MAN, "fit_2160p", 1, 1.0, False, "cpu", 0.0)
    assert seen == ["cubic_spline"] and res["attempted"] == 3
    assert res["metrics"] == {"fit_ms_per_step": {"value": 2.0, "unit": "ms"}, "setup_s": {"value": 1.0, "unit": "s"}}


def test_an_unknown_entry_raises(tmp_path):
    from port_bench import run

    here = tmp_path / "port_bench"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    cfg = manifest.config("flagship_2160p")
    cfg["entry"] = "no_such_entry"
    (here / "configs" / "flagship_2160p.json").write_text(json.dumps(cfg))
    with pytest.raises(KeyError, match="no_such_entry"):
        manifest.entry("no_such_entry")
    with pytest.raises(KeyError, match="no_such_entry"):
        run.result(MAN, "fit_2160p", 1, 1.0, False, "cpu", 0.0, here=str(here))


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_every_cell_reports_exactly_its_end_to_end_metrics(workload, tmp_path):
    """A whole run of each cell at a tiny size on the CPU, through `run.result`:
    its configuration and traffic swapped, under the same names, for its
    entry's CPU case (`tests/tiny_<entry>.py`)."""
    checks.check_tiny_cell(MAN, workload, manifest.HERE, str(tmp_path))


def test_new_metric_and_traffic_need_only_new_files(tmp_path):
    """A dummy reader and a dummy traffic file, dropped into a copy of the
    folder, are found by name with no edit of any file that is there."""
    here = tmp_path / "port_bench"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = {p: open(p, "rb").read() for p in map(str, here.rglob("*")) if os.path.isfile(p)}
    (here / "metrics" / "dummy_metric.fit.py").write_text("def read(ctx):\n    return ctx['summary']['steps'] * 2.0\n")
    (here / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"warm_steps": 5, "check_steps": 1, "trace_skip": 0, "trace_steps": 2}))
    man = json.loads(json.dumps(MAN))
    man["per_layer"].append({"name": "dummy_metric.fit", "unit": "ms", "better": "lower", "source": "device_trace",
                             "layer": "fit loop", "moves": "fit_ms_per_step", "workloads": ["dummy_cell"]})
    man["workloads"].append({"name": "dummy_cell", "config": "flagship_2160p", "traffic": "dummy_mix", "chips": 1,
                             "why": "a dummy"})
    rd = manifest.readers(man, "dummy_cell", here=str(here))
    assert set(rd) == {"dummy_metric.fit"} | {m["name"] for m in MAN["per_layer"]
                                              if "workloads" not in m or "dummy_cell" in m["workloads"]}
    assert rd["dummy_metric.fit"].read({"summary": {"steps": 4}}) == 8.0
    assert manifest.traffic("dummy_mix", here=str(here))["warm_steps"] == 5
    assert manifest.config(manifest.cell(man, "dummy_cell")["config"], here=str(here))["frame_size"] == [3840, 2160]
    assert all(open(p, "rb").read() == b for p, b in before.items())


def test_a_new_entry_point_needs_only_new_files(tmp_path):
    """A dummy entry, its configuration, traffic and limits, dropped into a
    copy of the folder, and a cell and an end-to-end metric of its own in the
    manifest: the run finds them by name with no edit of any file that is there."""
    from port_bench import run

    here = tmp_path / "port_bench"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = {p: open(p, "rb").read() for p in map(str, here.rglob("*")) if os.path.isfile(p)}
    (here / "entries" / "dummy_entry.py").write_text(
        "TRAFFIC_KEYS = ('calls',)\nLIMIT_KEYS = ('gap',)\n\n\n"
        "def run(cfg, traffic, limits, seed, seconds, trace, device, t_start, readers):\n"
        "    gap = cfg['gap']\n"
        "    return {'metrics': {'dummy_ms': 3.0 * traffic['calls'], 'setup_s': 0.5}, 'attempted': traffic['calls'],\n"
        "            'memory_peak_bytes': 0, 'phases': {},\n"
        "            'check': [{'name': 'gap', 'value': gap, 'limit': limits['gap'], 'ok': gap <= limits['gap']}]}\n")
    (here / "configs" / "dummy_cfg.json").write_text(json.dumps({"entry": "dummy_entry", "gap": 0.5}))
    (here / "traffic" / "dummy_mix.json").write_text(json.dumps({"calls": 4}))
    (here / "limits" / "dummy_cfg.json").write_text(json.dumps({"gap": 1.0}))
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg", "traffic": "dummy_mix", "chips": 1,
                             "why": "a dummy"})
    man["end_to_end"].append({"name": "dummy_ms", "unit": "ms", "better": "lower", "bound": 0.1,
                              "source": "host_clock", "workloads": ["dummy_cell"]})
    res, _ = run.result(man, "dummy_cell", 1, 1.0, False, "cpu", 0.0, here=str(here))
    assert res["metrics"] == {"dummy_ms": {"value": 12.0, "unit": "ms"}, "setup_s": {"value": 0.5, "unit": "s"}}
    assert res["correct"] and res["attempted"] == 4
    assert all(open(p, "rb").read() == b for p, b in before.items())


DUMMY_ENTRY = '''"""A dummy entry point: sums a vector drawn from the seed, `calls` times,
and holds the sum to its plain reference's (`reference/dummy.py`)."""

import importlib.util
import os
import time

import torch

TRAFFIC_KEYS = ("calls",)
LIMIT_KEYS = ("sum_gap",)
REFERENCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference", "dummy.py")


def run(cfg, traffic, limits, seed, seconds, trace, device, t_start, readers):
    spec = importlib.util.spec_from_file_location("port_bench_reference_dummy", REFERENCE)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    x = torch.rand(cfg["size"], generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    total = [float(x.sum()) for _ in range(traffic["calls"])][-1]
    ms = (time.perf_counter() - t0) * 1e3 / traffic["calls"]
    gap = abs(total - ref.total(x.tolist()))
    return {"metrics": {"preprocess_ms_per_frame": ms, "setup_s": setup_s}, "attempted": traffic["calls"],
            "memory_peak_bytes": 0, "phases": {},
            "check": [{"name": "sum_gap", "value": gap, "limit": limits["sum_gap"], "ok": gap <= limits["sum_gap"]}]}
'''
DUMMY_REFERENCE = '''"""The dummy entry's plain reference."""

import math


def total(values):
    return math.fsum(values)
'''
DUMMY_TINY = '''"""The dummy entry's CPU case."""

import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAFFIC = {"calls": 3}


def config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["size"] = 64
    return cfg
'''


def _dummy_entry(tmp_path, tiny=True):
    """A copy of the folder with a dummy entry point dropped in (the entry,
    its configuration, traffic, limits, reference and reader, and with `tiny`
    its CPU case), a manifest that adds its configuration, its cell and its
    reader, and appends the cell to `preprocess_ms_per_frame`'s workloads; and
    the bytes of every file that was there before."""
    here = tmp_path / "port_bench"
    shutil.copytree(manifest.HERE, here, ignore=checks.COPY_IGNORE)
    before = {p: open(p, "rb").read() for p in map(str, here.rglob("*")) if os.path.isfile(p)}
    source = "https://example.org/dummy"
    (here / "entries" / "dummy.py").write_text(DUMMY_ENTRY)
    (here / "reference" / "dummy.py").write_text(DUMMY_REFERENCE)
    (here / "metrics" / "dummy_calls.dummy.py").write_text("def read(ctx):\n    return ctx.get('calls')\n")
    (here / "configs" / "dummy_cfg.json").write_text(json.dumps(
        {"entry": "dummy", "source": source, "reduced": [], "size": 1 << 20}))
    (here / "traffic" / "dummy_mix.json").write_text(json.dumps({"calls": 40}))
    (here / "limits" / "dummy_cfg.json").write_text(json.dumps({"sum_gap": 1e-9}))
    if tiny:
        (here / "tests" / "tiny_dummy.py").write_text(DUMMY_TINY)
    man = json.loads(json.dumps(MAN))
    man["configs"].append({"name": "dummy_cfg", "source": source, "file": "port_bench/configs/dummy_cfg.json",
                           "reduced": [], "why": "a dummy"})
    man["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg", "traffic": "dummy_mix", "chips": 1,
                             "why": "a dummy"})
    next(m for m in man["end_to_end"] if m["name"] == "preprocess_ms_per_frame")["workloads"].append("dummy_cell")
    man["per_layer"].append({"name": "dummy_calls.dummy", "unit": "calls", "better": "lower",
                             "source": "program_counter", "layer": "dummy", "moves": "preprocess_ms_per_frame",
                             "workloads": ["dummy_cell"]})
    return str(here), man, before


def test_a_new_entrys_cell_passes_every_generic_check_with_new_files_only(tmp_path):
    """Every generic check holds the dummy entry's cell, and no file that was
    in the folder changes."""
    here, man, before = _dummy_entry(tmp_path)
    checks.check_configs(man, here)
    checks.check_workloads(man, here)
    checks.check_metrics(man, here)
    checks.check_reports(man)
    assert checks.entries(man, here) == ["dummy", "fit", "tracks"]
    res = checks.check_tiny_cell(man, "dummy_cell", here, str(tmp_path / "cell"))
    assert set(res["metrics"]) == {"preprocess_ms_per_frame", "setup_s"} and res["attempted"] == 3
    checks.check_reference_loads_nothing(here)
    checks.check_whole_run_loads_no_jax(man, "dummy", here, str(tmp_path / "whole"))
    assert all(open(p, "rb").read() == b for p, b in before.items())


def test_a_cell_whose_entry_has_no_cpu_case_fails(tmp_path):
    here, man, _ = _dummy_entry(tmp_path, tiny=False)
    with pytest.raises(AssertionError, match="add port_bench/tests/tiny_dummy.py"):
        checks.check_tiny_cell(man, "dummy_cell", here, str(tmp_path / "cell"))


@pytest.mark.parametrize("folder,module", [("reference", "splatter_a_video_tpu_torch"), ("counts", "jax")])
def test_a_reference_that_loads_the_program_or_jax_fails(tmp_path, folder, module):
    here, _, _ = _dummy_entry(tmp_path)
    checks.check_reference_loads_nothing(here)
    (tmp_path / "port_bench" / folder / "leaky.py").write_text(f"import {module}\n")
    with pytest.raises(AssertionError, match=f"loads {module}"):
        checks.check_reference_loads_nothing(here)
