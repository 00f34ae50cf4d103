"""The port's weight converters, `scripts/torch_convert_tapir.py` and
`scripts/torch_convert_depth_anything.py`, against the JAX package's
conversion of the same checkpoint: each `.npz` is array for array (keys,
dtypes, values and the `_meta_*` arrays) the file the JAX package writes,
and it loads through the port's `get_model`. The checkpoints are
the port's `nets.tapir.random_state_dict` (the reference's layout, random
weights) and `test_torch_nets`'s tiny `transformers` Depth-Anything
(skipped where `transformers` is missing).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from splatter_a_video_tpu.nets import depth_anything as jda
from splatter_a_video_tpu_torch.nets import depth_anything as tda
from splatter_a_video_tpu_torch.nets import tapir as ttapir

from test_torch_nets import hf_model, tiny_da_cfg  # noqa: F401  (hf_model: a fixture)

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"
TAPIR_CFG = ttapir.TapirConfig(initial_resolution=(32, 32), frame_chunk=3, extra_convs=2, num_mixer_blocks=2)
DA_HEADS, DA_TAPS = 2, [1, 2, 3, 4]   # hf_model's backbone_config


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same_npz(got_path, want_path):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def assert_loads(model, npz_path):
    assert model is not None and model.pretrained
    with np.load(npz_path) as z:
        stored = {k: z[k] for k in z.files if not k.startswith("_meta")}
    assert model.params.keys() == stored.keys()
    assert all(np.array_equal(model.params[k].numpy(), stored[k]) for k in stored)


@pytest.mark.parametrize("nesting", [None, "model", "state_dict"])
def test_tapir_npz_equals_jax_scripts(tmp_path, monkeypatch, nesting):
    """Both scripts on one saved checkpoint (also nested under 'model' /
    'state_dict') write the same arrays; the port loads them."""
    sd = ttapir.random_state_dict(TAPIR_CFG)
    ckpt = tmp_path / "tapir.pt"
    torch.save(sd if nesting is None else {nesting: sd}, ckpt)
    port, ref = tmp_path / "port.npz", tmp_path / "jax.npz"
    load_script("torch_convert_tapir").main(["--ckpt", str(ckpt), "--out", str(port)])
    load_script("convert_tapir").main(["--ckpt", str(ckpt), "--out", str(ref)])
    assert_same_npz(port, ref)
    monkeypatch.setenv("SPLAT_TAPIR_WEIGHTS", str(port))
    assert_loads(ttapir.get_model(TAPIR_CFG, device="cpu"), port)


def test_tapir_script_strict_names_unconsumed_keys(tmp_path):
    sd = ttapir.random_state_dict(TAPIR_CFG)
    ckpt = tmp_path / "renamed.pt"
    torch.save({**sd, "torch_pips_mixer.renamed": torch.zeros(1)}, ckpt)
    with pytest.raises(ValueError, match="Unconsumed: torch_pips_mixer.renamed"):
        load_script("torch_convert_tapir").main(["--ckpt", str(ckpt), "--out", str(tmp_path / "x.npz")])


@pytest.fixture(scope="module")
def da_checkpoint(hf_model, tmp_path_factory):
    """(state dict file, HF checkpoint directory, the JAX package's `.npz`)."""
    tmp = tmp_path_factory.mktemp("da")
    ckpt, hf_dir, ref = tmp / "sd.pt", tmp / "hf", tmp / "jax.npz"
    torch.save(hf_model.state_dict(), ckpt)
    hf_model.save_pretrained(str(hf_dir))
    jda.save_params(str(ref), jda.params_from_torch(hf_model.state_dict(), strict=True),
                    num_heads=DA_HEADS, out_indices=DA_TAPS)
    return ckpt, hf_dir, ref


@pytest.mark.parametrize("source", ["config", "flags", "model"])
def test_depth_anything_npz_equals_jax(da_checkpoint, tmp_path, monkeypatch, source):
    """The port's script from a state dict with the checkpoint's
    config.json, with --num_heads / --out_indices, or from the HF directory
    writes the JAX package's arrays; the port loads them with the tiny
    architecture."""
    ckpt, hf_dir, ref = da_checkpoint
    args = {"config": ["--ckpt", str(ckpt), "--config", str(hf_dir / "config.json")],
            "flags": ["--ckpt", str(ckpt), "--num_heads", str(DA_HEADS), "--out_indices", *map(str, DA_TAPS)],
            "model": ["--model", str(hf_dir)]}[source]
    port = tmp_path / "port.npz"
    load_script("torch_convert_depth_anything").main(args + ["--out", str(port)])
    assert_same_npz(port, ref)
    monkeypatch.setenv("SPLAT_DEPTH_ANYTHING_WEIGHTS", str(port))
    model = tda.get_model(device="cpu")
    assert_loads(model, port)
    assert model.cfg == tiny_da_cfg(tda)


def test_depth_anything_script_needs_the_architecture(da_checkpoint, tmp_path):
    ckpt = da_checkpoint[0]
    with pytest.raises(SystemExit):
        load_script("torch_convert_depth_anything").main(["--ckpt", str(ckpt), "--out", str(tmp_path / "x.npz")])
