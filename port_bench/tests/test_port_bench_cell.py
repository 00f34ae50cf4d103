"""One cell's whole run at a tiny size on the CPU (the program's plain
kernels), held to the reference with the committed limits; then the same run
with the timed path broken underneath, once for each fault a training cell
can have on one chip, which has to come out not correct."""

import time

import pytest
import torch

from port_bench import harness, manifest
from port_bench.tests import tiny_fit
from port_bench.tests.checks import check_whole_run_loads_no_jax, entries

SEED = 2 ** 31 + 12345          # past 32 signed bits, as a run's seed may be


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name="flagship_2160p"):
    out = harness.run_cell(tiny_fit.config(name), tiny_fit.TRAFFIC, manifest.limits(name), SEED, 0.5, False, "cpu",
                           time.perf_counter(), {}, [])
    return {c["name"]: c for c in out["check"]}, out


@pytest.mark.parametrize("name", ["flagship_2160p", "frag_gs_v10_2160p"])
def test_tiny_cell_is_correct(name):
    checks, out = _run(name)
    assert all(c["ok"] for c in checks.values()), checks
    assert out["steps"] >= 1 and out["fit_ms_per_step"] > 0 and out["events"]


def test_state_left_unchanged_fails(monkeypatch):
    from splatter_a_video_tpu_torch.train import trainer

    monkeypatch.setattr(trainer._optim, "adam_update", lambda cfg, params, grads, state, lr=None: (params, state))
    checks, _ = _run()
    assert not checks["change_gap"]["ok"] and not checks["grad_gap"]["ok"]


def test_half_the_batch_fails(monkeypatch):
    from splatter_a_video_tpu_torch.train import trainer

    rgb_loss = trainer._losses.rgb_loss
    monkeypatch.setattr(trainer._losses, "rgb_loss",
                        lambda pred, gt, lam=0.2: rgb_loss(pred[: pred.shape[0] // 2], gt[: gt.shape[0] // 2], lam))
    checks, _ = _run()
    assert not all(c["ok"] for c in checks.values())
    assert not checks["loss_gap"]["ok"]


def test_an_answer_altered_where_made_fails(monkeypatch):
    """K4's per-Gaussian sums lose the opacity row."""
    from splatter_a_video_tpu_torch.ops import rasterize_gpu

    reduce = rasterize_gpu.reduce_gaussians

    def altered(*a):
        out = reduce(*a)
        out[:, 5] = 0.0
        return out

    monkeypatch.setattr(rasterize_gpu, "reduce_gaussians", altered)
    checks, _ = _run()
    assert not checks["grad_gap"]["ok"]


@pytest.mark.parametrize("entry", entries(manifest.load_manifest(), manifest.HERE))
def test_a_whole_tiny_run_loads_no_jax(entry, tmp_path):
    """Each entry that a cell drives, its CPU case run whole in a fresh process."""
    check_whole_run_loads_no_jax(manifest.load_manifest(), entry, manifest.HERE, str(tmp_path))
