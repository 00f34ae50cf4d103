"""The manifest and every file it names keep to the benchmark's contract, and
the harness finds its files by name (a later cell, configuration, traffic
mix or metric is new files and entries only)."""

import json
import os
import re
import shutil

import pytest

from port_bench import manifest

ROOT = manifest.ROOT
MAN = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$|experts_per_tok)")


def test_top_level_keys_and_sizes():
    assert set(MAN) == TOP_KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w == p or w.startswith(p + "/") for p in MAN["paths"]), w


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(MAN["configs"]) <= 24
    files = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and LINE.match(c["why"])
        assert LINE.match(c["source"]) and c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in body and not WIDTHS.search(k)
        assert manifest.config(c["name"]) == body
        lim = set(manifest.limits(c["name"]))
        assert lim >= set(manifest.entry(manifest.entry_name(body)).LIMIT_KEYS)
        if manifest.entry_name(body) == "fit":
            assert lim >= {"loss_gap", "grad_gap", "change_gap"}
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_workloads():
    wls = MAN["workloads"]
    assert 1 <= len(wls) <= 24
    assert len({(w["config"], w["traffic"]) for w in wls}) == len(wls)
    assert sum(w["chips"] == 4 for w in wls) <= max(1, len(wls) // 4)
    configs = {c["name"] for c in MAN["configs"]}
    for w in wls:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in configs and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
        tr = manifest.traffic(w["traffic"])
        entry = manifest.entry_name(manifest.config(w["config"]))
        assert set(manifest.entry(entry).TRAFFIC_KEYS) <= set(tr)
        if entry == "fit":
            assert {"warm_steps", "check_steps", "trace_skip", "trace_steps"} <= set(tr)


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(MAN["per_layer"]) <= 128
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and LINE.match(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in MAN["workloads"]}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        assert callable(manifest.reader(m["name"]).read)
        layers.setdefault(m["layer"], []).append(m["name"])
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for layer in layers:
        assert layer in perf, layer


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_for(MAN, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_for(MAN, w["name"], "per_layer")


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
    its configuration and traffic swapped for tiny ones under the same names."""
    import torch

    from port_bench import run
    from port_bench.tests import tiny

    here = tmp_path / "port_bench"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    w = manifest.cell(MAN, workload)
    entry = manifest.entry_name(manifest.config(w["config"]))
    cfg, tr = ((tiny.tiny_config(w["config"]), tiny.TINY_TRAFFIC) if entry == "fit"
               else (tiny.tiny_tracks_config(w["config"]), tiny.TINY_TRACKS_TRAFFIC))
    (here / "configs" / f"{w['config']}.json").write_text(json.dumps(cfg))
    (here / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tr))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res, _ = run.result(MAN, workload, 2 ** 31 + 99, 0.3, False, "cpu", 0.0, here=str(here))
    finally:
        torch.set_num_threads(n)
    assert set(res["metrics"]) == {m["name"] for m in manifest.metrics_for(MAN, workload, "end_to_end")}
    assert res["correct"] and res["attempted"] > 0
    assert all(v["value"] > 0 for v in res["metrics"].values())


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
