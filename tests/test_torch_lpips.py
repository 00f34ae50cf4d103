"""The port's LPIPS and VGG perceptual loss against the JAX package's on
the CPU, with the same VGG16 weights (each package's `random_params` draws
the same arrays): distances and losses rtol 1e-5 (float32 convolutions
summed in other orders), the pinned random-trunk value of
`tests/test_lpips.py` at its rel 2e-3, the mask's `jax.image.resize`
weights at 1e-6, and the weight loaders equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.eval import lpips as jl
from splatter_a_video_tpu.eval import metrics as jmet
from splatter_a_video_tpu_torch import convert
from splatter_a_video_tpu_torch.eval import lpips as tl
from splatter_a_video_tpu_torch.eval import metrics as tmet
from splatter_a_video_tpu_torch.nets import interp as tinterp

from test_torch_fit import one_thread  # noqa: F401  (module fixture: one CPU thread)


def _pair(seed=0, hw=(33, 41)):
    rng = np.random.RandomState(seed)
    a = rng.rand(*hw, 3).astype(np.float32)
    b = np.clip(a + 0.25 * rng.randn(*hw, 3).astype(np.float32), 0, 1)
    return a, b


@pytest.fixture(autouse=True)
def default_models(monkeypatch):
    """No weights file: both packages' default models are the seed-0 random
    trunk, built afresh for each test."""
    monkeypatch.delenv("SPLAT_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(jl, "_MODEL", None)
    monkeypatch.setattr(tl, "_MODELS", {})


def test_random_params_match_jax():
    j, t = jl.random_params(7), tl.random_params(7)
    assert j.keys() == t.keys() and all(np.array_equal(j[k], t[k]) for k in j)


@pytest.mark.parametrize("seed,hw", [(0, (33, 41)), (5, (24, 28))])
def test_lpips_matches_jax(seed, hw):
    a, b = _pair(seed, hw)
    ref = jmet.lpips(a, b)
    got = tmet.lpips(a, b, device="cpu")
    assert got == pytest.approx(ref, rel=1e-5)
    assert tmet.lpips(a, a, device="cpu") < 1e-6
    assert 0 < tmet.lpips(a, np.clip(a + 0.01, 0, 1), device="cpu") < got


def test_pinned_random_trunk_value():
    a, b = _pair(3, (32, 32))
    assert tmet.lpips(a, b, device="cpu") == pytest.approx(0.0532191, rel=2e-3)
    assert tmet.lpips_is_pretrained(device="cpu") is False


def test_module_matches_jax_pair_function():
    params = jl.random_params(seed=2)
    a, b = _pair(1, (20, 22))
    x, y = (np.stack([a, b]) * 2 - 1).astype(np.float32), (np.stack([b, a]) * 2 - 1).astype(np.float32)
    ref = np.asarray(jl._lpips_pair({k: jnp.asarray(v) for k, v in params.items()}, x, y))
    got = convert.lpips_from_numpy(params, device="cpu")(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    for g, r in zip(tl.vgg_raw_taps(convert.lpips_from_numpy(params, device="cpu"), torch.from_numpy(x)),
                    jl.vgg_raw_taps({k: jnp.asarray(v) for k, v in params.items()}, x)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_vgg_perceptual_loss_matches_jax(masked):
    a, b = _pair(4, (40, 52))
    mask = (np.random.RandomState(9).rand(40, 52) > 0.4).astype(np.float32) if masked else None
    ref = jmet.vgg_perceptual_loss(a, b, mask)
    got = tmet.vgg_perceptual_loss(a, b, mask, device="cpu")
    assert got == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("shape", [(40, 52, 20, 26), (40, 52, 5, 6), (7, 9, 16, 11), (13, 13, 13, 13)])
def test_mask_resize_matches_jax_image_resize(shape):
    h, w, oh, ow = shape
    m = np.random.RandomState(1).rand(h, w).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(m), (oh, ow), "bilinear"))
    np.testing.assert_allclose(tinterp.jax_resize_bilinear(torch.from_numpy(m), oh, ow).numpy(), ref, atol=1e-6)


def _torchvision_layout(seed=0):
    rng = np.random.RandomState(seed)
    sd, torch_layer, cin = {}, 0, 3
    for c in tl.VGG16_CFG:
        if c == "M":
            torch_layer += 1
            continue
        sd[f"{torch_layer}.weight"] = rng.randn(c, cin, 3, 3).astype(np.float32) * 0.05
        sd[f"{torch_layer}.bias"] = rng.randn(c).astype(np.float32) * 0.01
        cin = c
        torch_layer += 2
    lin = {f"{s}.1.weight": rng.randn(1, c, 1, 1).astype(np.float32) for s, c in enumerate(tl.TAP_CHANNELS)}
    return sd, lin


@pytest.mark.parametrize("heads", [True, False])
def test_load_torch_params_match_jax(heads):
    sd, lin = _torchvision_layout()
    ref = jl.load_torch_params(sd, lin if heads else None)
    got = tl.load_torch_params(sd, lin if heads else None)
    assert got.keys() == ref.keys() and all(np.array_equal(got[k], ref[k]) for k in ref)


def test_npz_serves_both_packages(tmp_path, monkeypatch):
    p = str(tmp_path / "w.npz")
    tl.save_params(p, tl.random_params(2))
    monkeypatch.setenv("SPLAT_LPIPS_WEIGHTS", p)
    assert tl.get_model(device="cpu").pretrained and jl.get_model().pretrained
    a, b = _pair(2, (24, 24))
    assert tmet.lpips(a, b, device="cpu") == pytest.approx(jmet.lpips(a, b), rel=1e-5)
