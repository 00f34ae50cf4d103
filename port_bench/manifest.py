"""The benchmark's data, found by name: `BENCHMARK.json` at the repo's
root, `configs/<configuration>.json`, `traffic/<mix>.json`,
`limits/<configuration>.json`, `metrics/<metric>.py` and
`entries/<entry>.py` under this folder.

A configuration may name its `entry`, the program's entry point that its
cells drive (`fit` where it names none): `entries/<entry>.py` holds
`run(...)`, which sets up, measures, checks and traces one run, and the
keys its traffic files and limits must hold (`TRAFFIC_KEYS`,
`LIMIT_KEYS`). A later cell, configuration, mix, per-layer metric or entry
point is new files and new entries, never an edit of what is here. A new
entry point brings `entries/<entry>.py`; its configuration, traffic and
limits; its plain reference under `reference/` and its operation counts
under `counts/`; its readers under `metrics/`; its CPU case
`tests/tiny_<entry>.py` (`config(name)` and `TRAFFIC`, which the
benchmark's own tests find by the entry's name); and its configuration,
cells and metrics in `BENCHMARK.json`. A new cell that reports an
end-to-end metric that is already there appends its name to that metric's
`workloads`.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(kind: str, name: str, here: str = HERE) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(os.path.join(here, kind, name + ".json")) as f:
        return json.load(f)


def cell(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(name: str, here: str = HERE) -> dict:
    return _load_json("configs", name, here)


def traffic(name: str, here: str = HERE) -> dict:
    return _load_json("traffic", name, here)


def limits(name: str, here: str = HERE) -> dict:
    return _load_json("limits", name, here)


def entry_name(cfg: dict) -> str:
    """The entry point a configuration's cells drive."""
    return cfg.get("entry", "fit")


def _module(kind: str, prefix: str, name: str, here: str):
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(here, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {path}")
    spec = importlib.util.spec_from_file_location(f"{prefix}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str, here: str = HERE):
    """The module `entries/<name>.py`, which holds `run(...)`."""
    return _module("entries", "port_bench_entry", name, here)


def metrics_for(manifest: dict, workload: str, section: str) -> List[dict]:
    """The metrics of `section` (`end_to_end` or `per_layer`) that this cell
    reports: those without a `workloads` key, and those that list it."""
    return [m for m in manifest[section] if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, here: str = HERE):
    """The module `metrics/<name>.py`, which holds `read(ctx)`."""
    return _module("metrics", "port_bench_metric", name, here)


def readers(manifest: dict, workload: str, here: str = HERE) -> Dict[str, object]:
    return {m["name"]: reader(m["name"], here) for m in metrics_for(manifest, workload, "per_layer")}
