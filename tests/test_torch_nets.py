"""The port's preprocessing networks against the JAX package's on the CPU,
same numpy parameters (each package's `random_params` draws the same
arrays) and inputs:

  * `interp2d` (bilinear both align modes, bicubic) at 2e-5, the bar of
    `tests/test_depth_anything.py:85`;
  * the DINOv2 taps at 1e-4 and Depth-Anything end to end at 1e-3 on the
    tiny config of `tests/test_depth_anything.py:49-61` (square input, and
    a rectangular one that resamples the position grid), `infer_disparity`
    through the DPT sizing at 1e-3, the `.npz` round trip with the
    architecture read from the shapes, readable by both packages;
  * TAPIR (the default widths at a 32x32 inference resolution): the
    ResNet, ExtraConvs and mixer at atol 2e-4 / rtol 1e-4 (the mixer
    rtol 1e-3, as `tests/test_tapir.py`), the cost-volume initialisation
    and one whole pass at atol 5e-3 / rtol 1e-3
    (`tests/test_tapir.py:109-117`), the chunked `track_points` driver;
  * the converters: `params_from_torch` gives JAX's dicts on the same
    state dict (a tiny `transformers` Depth-Anything, skipped where
    `transformers` is missing; a synthetic TAPIR state dict), and the
    strict mode names unconsumed keys.
"""

import jax
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.nets import depth_anything as jda
from splatter_a_video_tpu.nets import interp as jinterp
from splatter_a_video_tpu.nets import tapir as jtapir
from splatter_a_video_tpu.nets import vit as jvit
from splatter_a_video_tpu_torch import convert
from splatter_a_video_tpu_torch.nets import convert_util as tcu
from splatter_a_video_tpu_torch.nets import depth_anything as tda
from splatter_a_video_tpu_torch.nets import interp as tinterp
from splatter_a_video_tpu_torch.nets import tapir as ttapir

from test_torch_fit import one_thread  # noqa: F401  (module fixture: one CPU thread)


@pytest.fixture(autouse=True)
def empty_jax_caches():
    """The JAX package's `depth_anything._infer` and `tapir._infer` jits
    take the model as a static argument compared by its array fields, and
    JAX's trace cache compares a new model with a cached one of the same
    structure, which raises `ValueError`. Whether two models meet in one
    process depends on which test files one worker runs (the JAX
    package's own network tests too), so each test here starts and ends
    with JAX's caches empty."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def tiny_da_cfg(mod):
    """The tiny config of `tests/test_depth_anything.py:49-61`."""
    return mod.DepthAnythingConfig(
        backbone=mod._vit.ViTConfig(hidden_size=32, num_layers=4, num_heads=2, mlp_ratio=4, patch_size=14,
                                    image_size=28),
        out_indices=(1, 2, 3, 4), neck_hidden_sizes=(8, 16, 24, 32), fusion_hidden_size=16, head_hidden_size=8,
    )


# ---- interp -------------------------------------------------------------------------


@pytest.mark.parametrize("mode,align", [("bilinear", False), ("bilinear", True), ("bicubic", False)])
@pytest.mark.parametrize("sizes", [(5, 13), (16, 7), (9, 9), (4, 17)])
def test_interp2d_matches_jax(mode, align, sizes):
    n_in, n_out = sizes
    x = np.random.RandomState(0).randn(2, n_in, n_in + 3, 3).astype(np.float32)
    ref = np.asarray(jinterp.interp2d(x, n_out, n_out + 1, mode, align))
    got = tinterp.interp2d(torch.from_numpy(x), n_out, n_out + 1, mode, align).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    assert np.array_equal(tinterp.resize_matrix(n_in, n_out, mode, align),
                          jinterp.resize_matrix(n_in, n_out, mode, align))


# ---- ViT and Depth-Anything -------------------------------------------------------


@pytest.fixture(scope="module")
def da_params():
    p = jda.random_params(tiny_da_cfg(jda), seed=3)
    tp = tda.random_params(tiny_da_cfg(tda), seed=3)
    assert p.keys() == tp.keys() and all(np.array_equal(p[k], tp[k]) for k in p)
    return p


@pytest.mark.parametrize("hw", [(28, 28), (28, 42)])
def test_vit_taps_match_jax(da_params, hw):
    x = np.random.RandomState(2).randn(2, *hw, 3).astype(np.float32)
    jcfg, tcfg = tiny_da_cfg(jda).backbone, tiny_da_cfg(tda).backbone
    ref = jvit.forward(jcfg, da_params, x, (0, 2, 4))
    got = convert.vit_from_numpy(da_params, tcfg, device="cpu")(torch.from_numpy(x), (0, 2, 4))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hw", [(28, 28), (28, 42)])
def test_depth_anything_matches_jax(da_params, hw):
    x = np.random.RandomState(4).randn(1, *hw, 3).astype(np.float32)
    ref = np.asarray(jda.forward(tiny_da_cfg(jda), da_params, x))
    got = convert.depth_anything_from_numpy(da_params, tiny_da_cfg(tda), device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, *hw) and ref.max() > 0.5   # seed 3: not all clipped by the ReLU
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_infer_disparity_matches_jax(da_params):
    import jax.numpy as jnp

    img = (np.random.RandomState(5).rand(30, 45, 3) * 255).astype(np.uint8)
    jm = jda.DepthAnythingModel(cfg=tiny_da_cfg(jda), params={k: jnp.asarray(v) for k, v in da_params.items()},
                                pretrained=False)
    ref = jda.infer_disparity(jm, img)
    got = tda.infer_disparity(convert.depth_anything_from_numpy(da_params, tiny_da_cfg(tda), device="cpu"), img)
    assert got.shape == (30, 45) and np.isfinite(got).all() and ref.max() > 0.5
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)
    assert tda._fit_size(480, 854) == jda._fit_size(480, 854) == (518, 924)
    np.testing.assert_allclose(tda.prepare_image(img, device="cpu").numpy(), np.asarray(jda.prepare_image(img)),
                               atol=2e-5)


def test_depth_anything_npz_serves_both_packages(da_params, tmp_path, monkeypatch):
    monkeypatch.delenv("SPLAT_DEPTH_ANYTHING_WEIGHTS", raising=False)
    assert tda.get_model(device="cpu") is None
    path = str(tmp_path / "w.npz")
    tda.save_params(path, da_params, num_heads=2, out_indices=(1, 2, 3, 4))
    monkeypatch.setenv("SPLAT_DEPTH_ANYTHING_WEIGHTS", path)
    tm, jm = tda.get_model(device="cpu"), jda.get_model()
    assert tm.pretrained and jm.pretrained
    assert tm.cfg == tiny_da_cfg(tda) and jm.cfg == tiny_da_cfg(jda)
    assert tm.params.keys() == da_params.keys()
    assert all(np.array_equal(tm.params[k].numpy(), da_params[k]) for k in da_params)


@pytest.fixture(scope="module")
def hf_state_dict():
    transformers = pytest.importorskip("transformers")
    backbone = transformers.Dinov2Config(
        image_size=28, patch_size=14, hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
        intermediate_size=128, out_indices=[1, 2, 3, 4], apply_layernorm=True, reshape_hidden_states=False,
        attn_implementation="eager")
    cfg = transformers.DepthAnythingConfig(backbone_config=backbone, reassemble_hidden_size=32,
                                           neck_hidden_sizes=[8, 16, 24, 32], fusion_hidden_size=16,
                                           head_hidden_size=8, patch_size=14)
    torch.manual_seed(0)
    return transformers.DepthAnythingForDepthEstimation(cfg).eval().state_dict()


def test_depth_anything_params_from_torch_match_jax(hf_state_dict):
    ref = jda.params_from_torch(hf_state_dict, strict=True)
    got = tda.params_from_torch(hf_state_dict, strict=True)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    assert tda.config_from_params(got, 2, (1, 2, 3, 4)) == tiny_da_cfg(tda)
    with pytest.raises(ValueError, match="1 state-dict keys not consumed"):
        tda.params_from_torch({**hf_state_dict, "neck.extra.weight": torch.zeros(1)}, strict=True)


# ---- TAPIR ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tapir():
    jcfg = jtapir.TapirConfig(initial_resolution=(32, 32), frame_chunk=3)
    tcfg = ttapir.TapirConfig(initial_resolution=(32, 32), frame_chunk=3)
    params = jtapir.random_params(jcfg, 0)
    return jcfg, tcfg, params, convert.tapir_from_numpy(params, tcfg, device="cpu")


def test_tapir_random_params_match_jax(tapir):
    jcfg, tcfg, params, _ = tapir
    tp = ttapir.random_params(tcfg, 0)
    assert tp.keys() == params.keys() and all(np.array_equal(tp[k], params[k]) for k in params)


def test_tapir_resnet_matches_jax(tapir):
    jcfg, tcfg, params, model = tapir
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    ref = jtapir.resnet_forward(jcfg, params, x)
    got = ttapir.resnet_forward(tcfg, model.params, torch.from_numpy(x))
    for unit in ("unit1", "unit3"):
        np.testing.assert_allclose(got[unit].numpy(), np.asarray(ref[unit]), atol=2e-4, rtol=1e-4, err_msg=unit)


def test_tapir_extra_convs_match_jax(tapir):
    jcfg, tcfg, params, model = tapir
    x = np.random.RandomState(2).randn(2, 4, 4, 256).astype(np.float32)
    ref = np.asarray(jtapir.extra_convs_forward(jcfg, params, x))
    got = ttapir.extra_convs_forward(tcfg, model.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def test_tapir_mixer_matches_jax(tapir):
    jcfg, tcfg, params, model = tapir
    x = np.random.RandomState(3).randn(5, 6, jcfg.mixer_in_dim).astype(np.float32)
    ref = np.asarray(jtapir.mixer_forward(jcfg, params, x))
    got = ttapir.mixer_forward(tcfg, model.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_tapir_samplers_match_jax():
    rng = np.random.RandomState(4)
    feats = rng.randn(3, 5, 6, 4).astype(np.float32)
    xy = rng.uniform(-1.5, 7.5, (7, 3, 9, 2)).astype(np.float32)
    for border in (False, True):
        ref = np.asarray(jtapir._sample_frames_bilinear(feats, xy, border))
        got = ttapir._sample_frames_bilinear(torch.from_numpy(feats), torch.from_numpy(xy), border).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, err_msg=str(border))
    tyx = np.stack([rng.uniform(-0.5, 3.5, 11), rng.uniform(-1, 6, 11), rng.uniform(-1, 7, 11)], 1)
    tyx = tyx.astype(np.float32)
    ref = np.asarray(jtapir._sample_trilinear(feats, tyx))
    np.testing.assert_allclose(ttapir._sample_trilinear(torch.from_numpy(feats), torch.from_numpy(tyx)).numpy(),
                               ref, atol=1e-6)
    heat = rng.rand(2, 3, 8, 9).astype(np.float32)
    heat[0, 0, 2, 3] = heat[0, 0, 5, 5] = 2.0    # a tie: the first argmax wins in both
    np.testing.assert_allclose(ttapir._soft_argmax_heatmap(torch.from_numpy(heat)).numpy(),
                               np.asarray(jtapir._soft_argmax_heatmap(heat)), atol=1e-5)


VIDEO_T = 6
QUERIES = np.array([[0, 5.0, 7.0], [2, 16.0, 9.0], [5, 28.0, 30.0], [3, 1.0, 2.0]], np.float32)


@pytest.fixture(scope="module")
def tapir_pass(tapir):
    jcfg, tcfg, params, model = tapir
    video = np.random.RandomState(4).rand(VIDEO_T, 32, 32, 3).astype(np.float32) * 2 - 1
    ref = jtapir.forward(jcfg, params, video, QUERIES)
    got = model(torch.from_numpy(video), torch.from_numpy(QUERIES))
    return video, ref, got


@pytest.mark.parametrize("key", ["tracks", "occlusion", "expected_dist"])
def test_tapir_forward_matches_jax(tapir_pass, key):
    _, ref, got = tapir_pass
    assert got[key].shape == ref[key].shape
    np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=5e-3, rtol=1e-3)


def test_tapir_cost_volume_init_matches_jax(tapir, tapir_pass):
    jcfg, tcfg, params, model = tapir
    video = tapir_pass[0]
    jlo, jhi = jtapir.get_feature_grids(jcfg, params, video)
    tlo, thi = ttapir.get_feature_grids(tcfg, model.params, torch.from_numpy(video))
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(thi.numpy(), np.asarray(jhi), atol=2e-4, rtol=1e-4)
    q = QUERIES * np.array([1.0, jlo.shape[1] / 32, jlo.shape[2] / 32], np.float32)
    jq = jtapir._sample_trilinear(jlo, q)
    ref = jtapir.tracks_from_cost_volume(jcfg, params, jq, jlo, QUERIES)
    got = ttapir.tracks_from_cost_volume(tcfg, model.params, torch.from_numpy(np.array(jq)),
                                         torch.from_numpy(np.array(jlo)), torch.from_numpy(QUERIES))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-3, rtol=1e-3)
    # the query frame snaps to the query point exactly
    assert np.array_equal(got[0][1, 2].numpy(), QUERIES[1, [2, 1]])


def test_track_points_pads_and_drops_the_pad(tapir):
    """5 queries in chunks of 3 (one padded chunk) give the rows of one
    unpadded pass, for the port as for JAX's driver."""
    jcfg, tcfg, params, model = tapir
    rng = np.random.RandomState(6)
    video = rng.randint(0, 255, (3, 40, 48, 3), dtype=np.uint8)
    qp = np.stack([np.zeros(5), rng.rand(5) * 39, rng.rand(5) * 47], -1).astype(np.float32)
    out = ttapir.track_points(model, video, qp, chunk=3)
    assert out["tracks"].shape == (5, 3, 2) and out["occlusion"].shape == (5, 3)
    whole = model(torch.from_numpy(video.astype(np.float32) / 255.0 * 2.0 - 1.0), torch.from_numpy(qp))
    for k in out:
        np.testing.assert_allclose(out[k], whole[k].numpy(), atol=1e-4, rtol=1e-4, err_msg=k)


def _tapir_state_dict(cfg, seed=0):
    """A torch TAPIR state dict (the reference's names and layouts) of
    random arrays."""
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    sd = {"resnet_torch.initial_conv.weight": r(64, 3, 7, 7)}
    cin = 64
    for g, (nb, cout) in enumerate(zip(cfg.blocks_per_group, cfg.channels_per_group)):
        for b in range(nb):
            src = f"resnet_torch.block_groups.{g}.blocks.{b}."
            c_in_b = cin if b == 0 else cout
            sd.update({src + "bn_0.weight": r(c_in_b), src + "bn_0.bias": r(c_in_b), src + "conv_0.weight":
                       r(cout, c_in_b, 3, 3), src + "bn_1.weight": r(cout), src + "bn_1.bias": r(cout),
                       src + "conv_1.weight": r(cout, cout, 3, 3)})
            if b == 0:
                sd[src + "proj_conv.weight"] = r(cout, c_in_b, 1, 1)
        cin = cout
    for i in range(2):
        src = f"extra_convs.blocks.{i}."
        sd.update({src + "layer_norm.weight": r(256), src + "layer_norm.bias": r(256), src + "conv.weight":
                   r(1024, 256, 3, 3), src + "conv.bias": r(1024), src + "conv_1.weight": r(256, 1024, 3, 3),
                   src + "conv_1.bias": r(256)})
    cv = "torch_cost_volume_track_mods."
    sd.update({cv + "hid1.weight": r(16, 1, 3, 3), cv + "hid1.bias": r(16), cv + "hid2.weight": r(1, 16, 3, 3),
               cv + "hid2.bias": r(1), cv + "hid3.weight": r(32, 16, 3, 3), cv + "hid3.bias": r(32),
               cv + "hid4.weight": r(16, 32), cv + "hid4.bias": r(16), cv + "occ_out.weight": r(2, 16),
               cv + "occ_out.bias": r(2)})
    mx = "torch_pips_mixer."
    sd.update({mx + "linear.weight": r(512, 535), mx + "linear.bias": r(512), mx + "layer_norm.weight": r(512),
               mx + "linear_1.weight": r(388, 512), mx + "linear_1.bias": r(388)})
    for i in range(2):
        src = mx + f"blocks.{i}."
        sd.update({src + "layer_norm.weight": r(512), src + "mlp1_up.weight": r(2048, 1, 3),
                   src + "mlp1_up.bias": r(2048), src + "mlp1_up_1.weight": r(2048, 1, 3),
                   src + "mlp1_up_1.bias": r(2048), src + "layer_norm_1.weight": r(512),
                   src + "conv_channels_mixer.mlp2_up.weight": r(2048, 512),
                   src + "conv_channels_mixer.mlp2_up.bias": r(2048),
                   src + "conv_channels_mixer.mlp2_down.weight": r(512, 2048),
                   src + "conv_channels_mixer.mlp2_down.bias": r(512)})
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def test_tapir_params_from_torch_match_jax(tapir):
    sd = _tapir_state_dict(tapir[1])
    ref = jtapir.params_from_torch({k: v.numpy() for k, v in sd.items()}, strict=True)
    got = ttapir.params_from_torch(sd, strict=True)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    with pytest.raises(ValueError, match="Unconsumed: torch_pips_mixer.renamed"):
        ttapir.params_from_torch({**sd, "torch_pips_mixer.renamed": torch.zeros(1)}, strict=True)
    used = tcu.RecordingStateDict(sd)
    _ = used["resnet_torch.initial_conv.weight"]
    assert used.used == {"resnet_torch.initial_conv.weight"} and len(used) == len(sd)


def test_tapir_get_model_gated(tmp_path, monkeypatch):
    monkeypatch.delenv("SPLAT_TAPIR_WEIGHTS", raising=False)
    assert ttapir.get_model(device="cpu") is None
    cfg = ttapir.TapirConfig(initial_resolution=(16, 16))
    params = ttapir.random_params(cfg, 0)
    path = str(tmp_path / "t.npz")
    ttapir.save_params(path, params)
    monkeypatch.setenv("SPLAT_TAPIR_WEIGHTS", path)
    m = ttapir.get_model(cfg, device="cpu")
    assert m is not None and m.pretrained and m.params.keys() == params.keys()
    assert jtapir.get_model(jtapir.TapirConfig(initial_resolution=(16, 16))).params.keys() == params.keys()
