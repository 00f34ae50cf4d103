"""Guards on the port package: it imports nothing of JAX or of the JAX
package, and its entry points run on the GPU unless told otherwise."""

import ast
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from splatter_a_video_tpu_torch import convert, inference
from splatter_a_video_tpu_torch.apps import train as train_app
from splatter_a_video_tpu_torch.apps import train_state_io
from splatter_a_video_tpu_torch.eval import tapvid
from splatter_a_video_tpu_torch.models import gaussians
from splatter_a_video_tpu_torch.train import fit, trainer
from splatter_a_video_tpu_torch.utils import checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "splatter_a_video_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "flax", "splatter_a_video_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "splatter_a_video_tpu_torch." + ".".join(p.relative_to(ROOT / "splatter_a_video_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "splatter_a_video_tpu_torch").rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize(
    "fn",
    [inference.render_frame, inference.render_video, inference.render_nvs,
     inference.render_stereo, convert.scene_from_numpy, convert.train_state_from_numpy,
     gaussians.create_scene, trainer.init_train_state, trainer.make_train_step,
     fit.fit_clip, fit.build_scene_from_clip, fit.scene_from_tracks, inference.track_correspondences,
     inference.gaussian_trajectories, tapvid.evaluate_scene_tracking, train_state_io.load_scene_from_ckpt,
     checkpoint.load_state_dict],
    ids=lambda f: f.__name__,
)
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_render_without_device_raises_without_gpu():
    """Without a GPU the default device raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device renders there")

    from splatter_a_video_tpu_torch.models.gaussians import GaussianScene, SceneConfig
    from splatter_a_video_tpu_torch.ops.rasterize import RasterizeConfig

    n = 4
    scene = GaussianScene(
        params={"position": torch.zeros(n, 3), "features_dc": torch.zeros(n, 1, 3),
                "features_rest": torch.zeros(n, 15, 3), "scaling": torch.zeros(n, 3),
                "rotation": torch.zeros(n, 4), "opacity": torch.zeros(n, 1)},
        aux={"alive": torch.ones(n, dtype=torch.bool)},
        cfg=SceneConfig(capacity=n, num_frames=1, traj="static"),
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.render_frame(scene, 0.0, np.eye(3, 4), RasterizeConfig(width=16, height=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.scene_from_numpy({}, {}, {"capacity": 1, "num_frames": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.make_train_step(trainer.TrainerConfig(width=16, height=16, num_frames=1), np.eye(3, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.init_train_state(trainer.TrainerConfig(width=16, height=16, num_frames=1), scene)


def test_fit_and_cli_without_device_raise_without_gpu(tmp_path):
    """`fit_clip` and the training CLI train on the GPU unless told
    otherwise; without one they raise before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device trains there")
    from splatter_a_video_tpu_torch.data import synthetic

    clip = synthetic.make_clip(synthetic.SyntheticClipConfig(num_frames=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit.fit_clip(clip, fit.FitConfig(num_iters=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_app.main(["--synthetic", "--num_iters", "1", "--out_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.track_correspondences(None, 0.0, np.zeros((1, 2)), 1.0, None, None)
