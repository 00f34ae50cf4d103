"""PLY import/export of Gaussian scenes (counterpart of
`splatter_a_video_tpu/utils/ply.py`; numpy).

Binary little-endian PLY with flattened per-attribute float columns named
`<attr>_<i>`. Only alive Gaussians are exported; import re-packs columns
by prefix into the scene parameter dict. Callers pass numpy arrays
(`tensor.cpu().numpy()`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _flatten_params(params: Dict[str, np.ndarray], alive: np.ndarray):
    cols: List[Tuple[str, np.ndarray]] = []
    for name, v in params.items():
        arr = np.asarray(v)[alive].reshape(np.sum(alive), -1).astype(np.float32)
        if arr.shape[1] == 1:
            cols.append((name, arr[:, 0]))
        else:
            for i in range(arr.shape[1]):
                cols.append((f"{name}_{i}", arr[:, i]))
    return cols


def save_ply(path: str, params: Dict[str, np.ndarray], alive: np.ndarray) -> None:
    alive = np.asarray(alive, bool)
    cols = _flatten_params(params, alive)
    n = int(np.sum(alive))
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in cols]
    header += ["end_header"]
    data = np.stack([c for _, c in cols], axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def load_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY written by `save_ply`; returns name -> [N, k] arrays with
    columns re-grouped by attribute prefix."""
    with open(path, "rb") as f:
        props: List[str] = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        raw = np.frombuffer(f.read(4 * n * len(props)), dtype="<f4")
    table = raw.reshape(n, len(props))

    groups: Dict[str, List[Tuple[int, int]]] = {}
    for ci, p in enumerate(props):
        if "_" in p and p.rsplit("_", 1)[1].isdigit():
            base, idx = p.rsplit("_", 1)
            groups.setdefault(base, []).append((int(idx), ci))
        else:
            groups.setdefault(p, []).append((0, ci))
    out = {}
    for base, cols in groups.items():
        cols = sorted(cols)
        out[base] = np.stack([table[:, ci] for _, ci in cols], axis=1)
    return out
