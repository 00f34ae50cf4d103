"""The benchmark's data, found by name: `BENCHMARK.json` at the repo's
root, `configs/<configuration>.json`, `traffic/<mix>.json`,
`limits/<configuration>.json` and `metrics/<metric>.py` under this folder.
A later cell, configuration, mix or per-layer metric is new files and new
entries, never an edit of what is here.
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


def metrics_for(manifest: dict, workload: str, section: str) -> List[dict]:
    """The metrics of `section` (`end_to_end` or `per_layer`) that this cell
    reports: those without a `workloads` key, and those that list it."""
    return [m for m in manifest[section] if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, here: str = HERE):
    """The module `metrics/<name>.py`, which holds `read(ctx)`."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readers(manifest: dict, workload: str, here: str = HERE) -> Dict[str, object]:
    return {m["name"]: reader(m["name"], here) for m in metrics_for(manifest, workload, "per_layer")}
