"""The port's production harness, `scripts/torch_e2e_480p.py`, against the
JAX package's, `scripts/e2e_480p.py`, on the CPU at the harness's QUICK
size (214x120, 8 frames, 800 points in 1,152 slots):

  * [quick]: 5 steps; [schedule]: 8 steps across the production density
    machinery moved forward (events at 4, 6 and 8 under a growth budget of
    0.05, an opacity reset at 6) with the lr horizon (4) below the step
    count, so that 4 steps run at the clamped rate;
  * the JAX script runs in a subprocess from a copy under `tmp_path`, so
    nothing lands in the tree; the port's `run` in this process;
  * the two last-line records agree: the same keys; `scale`, `final_alive`,
    `saturation`, `densify_totals` and `eval_num_intersections` exactly;
    every `recon` and `tapvid` number within 0.011, one unit of the
    printed digit;
  * `scripts/torch_fit_log.py` prints every log step of the same fit;
  * in QUICK mode the port writes no file; without `E480_CPU=1` /
    `CAP_CPU=1` both harnesses run on the GPU, and without one they raise
    before any work.
"""

import ast
import importlib.util
import inspect
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from test_torch_fit import one_thread  # noqa: F401  (autouse module fixture: one CPU thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DIGIT = 0.011     # one unit of the records' second decimal, and the rounding
CASES = {
    "quick": dict(E480_QUICK="1", E480_TEXTURE="1", E480_STEPS="5"),
    "schedule": dict(E480_QUICK="1", E480_TEXTURE="1", E480_STEPS="8", E480_DENSIFY_START="3",
                     E480_DENSIFY_INT="2", E480_RESET_INT="5", E480_GROWTH_FRAC="0.05", E480_LR_STEPS="4"),
}
EXACT = ("scale", "final_alive", "saturation", "densify_totals", "eval_num_intersections")


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start_jax_script(name: str, env: dict, tmp_path: pathlib.Path) -> subprocess.Popen:
    """The JAX script `scripts/<name>.py`, copied under `tmp_path/scripts/`
    (its outputs land under `tmp_path`), started on the CPU."""
    (tmp_path / "scripts").mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "scripts" / f"{name}.py", tmp_path / "scripts")
    full = {k: v for k, v in os.environ.items() if not k.startswith(("E480_", "CAP_")) and k != "XLA_FLAGS"}
    full.update(env, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", SAV_TPU_CACHE_DIR=str(tmp_path / "jax_cache"))
    return subprocess.Popen([sys.executable, f"scripts/{name}.py"], cwd=tmp_path, env=full,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def last_record(proc: subprocess.Popen) -> dict:
    out = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, out[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def assert_close(got, want, what):
    assert abs(got - want) <= DIGIT, f"{what}: port {got}, JAX {want}"


@pytest.fixture(scope="module")
def e2e():
    return load_script("torch_e2e_480p")


@pytest.mark.parametrize("case", sorted(CASES))
def test_record_matches_jax(e2e, case, tmp_path):
    proc = start_jax_script("e2e_480p", {**CASES[case], "E480_CPU": "1"}, tmp_path / "jax")
    port_root = tmp_path / "port"
    port_root.mkdir()
    got = e2e.run(e2e.read_env({**CASES[case], "E480_CPU": "1"}), device="cpu", root=str(port_root))[0]
    want = last_record(proc)

    assert got.keys() == want.keys()
    for k in EXACT:
        assert got[k] == want[k], f"{k}: port {got[k]}, JAX {want[k]}"
    assert got["recon"].keys() == want["recon"].keys()
    assert got["recon"]["lpips_is_pretrained"] == want["recon"]["lpips_is_pretrained"]
    for k in ("psnr", "ssim", "lpips_fallback", "psnr_min", "psnr_max"):
        assert_close(got["recon"][k], want["recon"][k], k)
    assert len(got["recon"]["psnr_per_frame"]) == len(want["recon"]["psnr_per_frame"]) == 8
    for i, (a, b) in enumerate(zip(got["recon"]["psnr_per_frame"], want["recon"]["psnr_per_frame"])):
        assert_close(a, b, f"psnr of frame {i}")
    assert got["tapvid"].keys() == want["tapvid"].keys()
    for k, v in want["tapvid"].items():
        assert_close(got["tapvid"][k], v, k)
    assert got["hardware"] == "cpu"
    if case == "schedule":   # the machinery ran: three events, one reset
        assert got["densify_totals"]["events"] == 3
        assert got["scale"]["max_growth_frac"] == 0.05
    assert not list(port_root.rglob("*")), "QUICK mode wrote files"


def test_defaults_are_the_flagship_run(e2e):
    """With no knobs set the port runs the JAX script's production shape."""
    s = e2e.read_env({})
    fcfg, tcfg = e2e.fit_configs(s)
    assert (s.width, s.height, s.frames, s.steps, s.grid, s.maxi) == (854, 480, 48, 20_000, 2, 1 << 20)
    assert (fcfg.init_num_points, fcfg.num_track_samples, fcfg.capacity_factor, fcfg.log_every) == \
        (100_000, 4096, 1.31, 500)
    d = tcfg.densify
    assert (d.densify_start_iter, d.duplicate_interval, d.opacity_reset_interval, d.max_growth_frac,
            d.size_prune_always, d.saturation_stop) == (500, 100, 3000, 0.0, True, 0.97)
    assert (tcfg.nearest, tcfg.loss_flow_weight, tcfg.optim.max_steps) == (0.2, 20.0, 20_000)
    flagship = e2e.read_env(dict(E480_TEXTURE="1", E480_GROWTH_FRAC="0.05", E480_LR_STEPS="8000"))
    _, tcfg = e2e.fit_configs(flagship)
    assert (tcfg.loss_flow_weight, tcfg.optim.max_steps, tcfg.densify.max_growth_frac) == (2.0, 8000, 0.05)
    assert os.path.basename(e2e.record_path(flagship, 131_072)) == "METRICS_480p_torch.json"
    assert e2e.scene_path(flagship).endswith(os.path.join("out", "e480_torch", "final_scene.npz"))


@pytest.mark.parametrize("name", ["torch_e2e_480p", "torch_capability_480p"])
def test_harness_runs_on_cuda_unless_told(name, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the harness runs there")
    mod = load_script(name)
    assert inspect.signature(mod.run).parameters["device"].default == "cuda"
    for k in list(os.environ):
        if k.startswith(("E480_", "CAP_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("E480_QUICK", "1")
    monkeypatch.setenv("CAP_QUICK", "1")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


def test_fit_log_prints_each_log_step(monkeypatch, capsys):
    for k in list(os.environ):
        if k.startswith("E480_"):
            monkeypatch.delenv(k)
    for k, v in CASES["quick"].items():
        monkeypatch.setenv(k, v)
    assert load_script("torch_fit_log").main(["--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("budget 32768: ")]
    assert len(lines) == 2
    steps = ast.literal_eval(lines[0].split(":", 2)[2].strip())
    assert [row[0] for row in steps] == [1, 2, 3, 4, 5] and all(row[4] == 800 for row in steps)
    assert json.loads(lines[1].split("record", 1)[1])["recon_psnr"] > 0
