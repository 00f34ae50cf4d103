"""The benchmark's generic checks, each a function of a manifest and a folder:
`port_bench/` itself, or a copy of it with new files dropped in. The tests
call them on the repository, and `test_port_bench_manifest.py` calls them on
a copy that holds a dummy entry point, so that a new entry's cell is held by
every one of them with no edit of a file that is there.

An entry point brings its CPU case as `tests/tiny_<entry>.py`, found by the
entry's name: `config(name)`, the configuration cut to run in seconds on the
CPU with every kind of layer kept, and `TRAFFIC`, the traffic mix it runs.
A cell whose entry has none fails here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

from port_bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$|experts_per_tok)")
# what the reference and the counts may not load: JAX, Flax, the JAX package and the program
NOT_IN_REFERENCE = {"jax", "jaxlib", "flax", "splatter_a_video_tpu", "splatter_a_video_tpu_torch"}
COPY_IGNORE = shutil.ignore_patterns("__pycache__", "_cache")


def root_of(here: str) -> str:
    """The checkout that holds the folder (`BENCHMARK.json`'s paths are relative to it)."""
    return os.path.dirname(os.path.abspath(here))


def check_configs(man: dict, here: str) -> None:
    assert 1 <= len(man["configs"]) <= 24
    files = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and LINE.match(c["why"])
        assert LINE.match(c["source"]) and c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(root_of(here), c["file"])) as f:
            body = json.load(f)
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in body and not WIDTHS.search(k)
        assert manifest.config(c["name"], here) == body
        lim = set(manifest.limits(c["name"], here))
        assert lim >= set(manifest.entry(manifest.entry_name(body), here).LIMIT_KEYS)
        if manifest.entry_name(body) == "fit":
            assert lim >= {"loss_gap", "grad_gap", "change_gap"}
        assert any(w["config"] == c["name"] for w in man["workloads"])


def check_workloads(man: dict, here: str) -> None:
    wls = man["workloads"]
    assert 1 <= len(wls) <= 24
    assert len({(w["config"], w["traffic"]) for w in wls}) == len(wls)
    assert sum(w["chips"] == 4 for w in wls) <= max(1, len(wls) // 4)
    configs = {c["name"] for c in man["configs"]}
    for w in wls:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in configs and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
        tr = manifest.traffic(w["traffic"], here)
        entry = manifest.entry_name(manifest.config(w["config"], here))
        assert set(manifest.entry(entry, here).TRAFFIC_KEYS) <= set(tr)
        if entry == "fit":
            assert {"warm_steps", "check_steps", "trace_skip", "trace_steps"} <= set(tr)


def check_metrics(man: dict, here: str) -> None:
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(man["per_layer"]) <= 128
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and LINE.match(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in man["workloads"]}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        assert callable(manifest.reader(m["name"], here).read)


def check_reports(man: dict) -> None:
    """Every cell reports `setup_s`, another end-to-end metric and a per-layer metric."""
    for w in man["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_for(man, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert manifest.metrics_for(man, w["name"], "per_layer"), w["name"]


def entries(man: dict, here: str) -> list:
    """The entry points that the manifest's cells drive."""
    return sorted({manifest.entry_name(manifest.config(w["config"], here)) for w in man["workloads"]})


def tiny_case(entry: str, here: str):
    """The module `tests/tiny_<entry>.py` of the folder."""
    path = os.path.join(here, "tests", f"tiny_{entry}.py")
    assert os.path.isfile(path), (f"the {entry} entry has no CPU case: add port_bench/tests/tiny_{entry}.py "
                                  "with config(name) and TRAFFIC")
    spec = importlib.util.spec_from_file_location(f"port_bench_tiny_{entry}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_copy(man: dict, workload: str, here: str, dest: str) -> str:
    """A copy of the folder under `dest` in which the cell's configuration and
    traffic are its entry's CPU case, under the same names; `dest` also gets
    the manifest as `BENCHMARK.json`. Returns the copy's folder."""
    w = manifest.cell(man, workload)
    case = tiny_case(manifest.entry_name(manifest.config(w["config"], here)), here)
    out = os.path.join(dest, "port_bench")
    shutil.copytree(here, out, ignore=COPY_IGNORE)
    with open(os.path.join(out, "configs", f"{w['config']}.json"), "w") as f:
        json.dump(case.config(w["config"]), f)
    with open(os.path.join(out, "traffic", f"{w['traffic']}.json"), "w") as f:
        json.dump(case.TRAFFIC, f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return out


def check_tiny_cell(man: dict, workload: str, here: str, dest: str) -> dict:
    """A whole run of the cell at its CPU case's size, through `run.result`
    on one thread: correct, with exactly the cell's end-to-end metrics, each
    above 0. Returns the result line's fields."""
    import torch

    from port_bench import run

    tiny = tiny_copy(man, workload, here, dest)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res, _ = run.result(man, workload, 2 ** 31 + 99, 0.3, False, "cpu", 0.0, here=tiny)
    finally:
        torch.set_num_threads(n)
    assert set(res["metrics"]) == {m["name"] for m in manifest.metrics_for(man, workload, "end_to_end")}
    assert res["correct"] and res["attempted"] > 0, res
    assert all(v["value"] > 0 for v in res["metrics"].values()), res["metrics"]
    return res


def _fresh(code: str, here: str, timeout: float) -> str:
    """Run `code` in a fresh interpreter whose `port_bench` is the folder's
    (the repository's root after it, for the program); its standard output."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    path = [root_of(here), manifest.ROOT]
    res = subprocess.run([sys.executable, "-c", f"import sys; sys.path[:0] = {path!r}; {code}"],
                         capture_output=True, text=True, env=env, cwd=root_of(here), timeout=timeout)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


def check_reference_loads_nothing(here: str) -> None:
    """Every module under `reference/` and `counts/`, loaded in a fresh
    process, leaves no module of JAX, Flax, the JAX package or the program
    loaded (whole top-level names)."""
    mods = [f"port_bench.{d}.{n[:-3]}" for d in ("reference", "counts")
            for n in sorted(os.listdir(os.path.join(here, d))) if n.endswith(".py") and n != "__init__.py"]
    assert mods
    out = _fresh(f"import importlib; [importlib.import_module(m) for m in {mods!r}]; "
                 "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))", here, 300)
    bad = set(out.split()) & NOT_IN_REFERENCE
    assert not bad, f"loading {', '.join(mods)} loads {', '.join(sorted(bad))}"


def check_whole_run_loads_no_jax(man: dict, entry: str, here: str, dest: str) -> None:
    """The entry's CPU case, run whole through `run.result` in a fresh process
    (the first cell that drives the entry): correct, and
    `run.forbidden_modules()` is empty once it has ended."""
    workload = next(w["name"] for w in man["workloads"]
                    if manifest.entry_name(manifest.config(w["config"], here)) == entry)
    tiny = tiny_copy(man, workload, here, dest)
    out = _fresh("import time, torch; torch.set_num_threads(1); "
                 "from port_bench import manifest, run; "
                 f"res, _ = run.result(manifest.load_manifest({dest!r}), {workload!r}, 5, 0.2, False, 'cpu', "
                 f"time.perf_counter(), here={tiny!r}); "
                 "print(res['correct'], run.forbidden_modules())", tiny, 600)
    assert out.strip().splitlines()[-1] == "True []", out[-2000:]
