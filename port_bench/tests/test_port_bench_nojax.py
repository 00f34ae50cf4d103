"""Nothing the benchmark loads is JAX, Flax or the JAX package (whole
top-level names), and the reference loads nothing of the program."""

import os
import subprocess
import sys

from port_bench import manifest
from port_bench.run import forbidden_modules
from port_bench.tests import checks

ROOT = manifest.ROOT


def test_whole_top_level_names():
    mods = {"jax.numpy": 1, "jaxlib": 1, "flax.linen": 1, "splatter_a_video_tpu.ops": 1,
            "splatter_a_video_tpu_torch.ops": 1, "jaxtyping": 1, "flaxx": 1, "numpy": 1}
    assert forbidden_modules(mods) == ["flax", "jax", "jaxlib", "splatter_a_video_tpu"]
    assert forbidden_modules({"splatter_a_video_tpu_torch": 1, "port_bench.run": 1}) == []


def _modules_after(code: str):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    out = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); {code}; "
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_harness_and_the_program_load_no_jax():
    mods = _modules_after(
        "import port_bench.run, port_bench.harness, port_bench.compare, port_bench.trace, port_bench.clip; "
        "import port_bench.control_tracks, port_bench.counts.tapir; "
        "from port_bench import manifest as m; man = m.load_manifest(); "
        "[m.readers(man, w['name']) for w in man['workloads']]; "
        "[m.entry(m.entry_name(m.config(w['config']))) for w in man['workloads']]; "
        "import splatter_a_video_tpu_torch.nets.tapir; "
        "import splatter_a_video_tpu_torch.train.fit, splatter_a_video_tpu_torch.data.video_flow")
    assert "splatter_a_video_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "splatter_a_video_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    """Every module under `reference/` and `counts/`, found by folder."""
    checks.check_reference_loads_nothing(manifest.HERE)
