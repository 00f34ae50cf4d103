"""The port's tutorials, `examples/torch_gs_2d.py` and
`examples/torch_gs_3d.py`, against the JAX package's, `examples/gs_2d.py`
and `examples/gs_3d.py`, on the CPU (JAX's Pallas blend in interpret mode):

  * gs_2d: JAX's initial draws (`xyz`, `scale` exact, the normal draws at
    atol 1e-6); 4 Adam steps at 32x32 with 300 points: losses and PSNRs at
    rtol 1e-5, parameters at atol 2e-5, the final image at atol 5e-5, and
    every depth still exactly 1.0 (the fit blends ties alone);
  * gs_3d: the torus, its SH and the orbit transforms equal; 3 views at
    64x64 with 2,000 points: rgb at atol 2e-5, radii and visibility equal;
  * each tutorial's `main` passes its own asserts with `--device cpu`, and
    raises without a GPU when asked for cuda (its default).
"""

import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu.models import legacy_render as jlegacy
from splatter_a_video_tpu.ops.quaternion import quat_normalize as jquat_normalize
from splatter_a_video_tpu_torch.train import prng

from test_torch_fit import one_thread  # noqa: F401  (autouse module fixture: one CPU thread)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
FIT = dict(num_points=300, iters=4, log_every=1, max_intersections=1 << 14)


def load_example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gs2d():
    return load_example("gs_2d"), load_example("torch_gs_2d")


@pytest.fixture(scope="module")
def gs3d():
    return load_example("gs_3d"), load_example("torch_gs_3d")


@pytest.fixture(scope="module")
def fits(gs2d):
    """(JAX fit, port fit): each (params, image, history) of FIT at 32x32."""
    jmod, tmod = gs2d
    target = jmod.make_target(32)
    assert np.array_equal(tmod.make_target(32), target)
    jp, jimg, jhist = jmod.fit(target, **FIT)
    tp, timg, thist = tmod.fit(target, **FIT, device="cpu")
    return ({k: np.asarray(v) for k, v in jp.items()}, np.asarray(jimg), jhist), \
        ({k: v.numpy() for k, v in tp.items()}, timg.numpy(), thist)


def test_init_params_are_jax_draws(gs2d):
    jmod, tmod = gs2d
    want = jmod.init_params(jax.random.PRNGKey(0), 10_000)
    got = tmod.init_params(prng.key(0), 10_000)
    assert got.keys() == want.keys()
    for k in ("xyz", "scale"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in ("rotate", "opacity", "rgb"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6, err_msg=k)
    assert (got["xyz"][:, 2] == 1.0).all()


def test_fit_losses_match_jax(fits):
    (_, _, jhist), (_, _, thist) = fits
    assert [h[0] for h in thist] == [h[0] for h in jhist] == list(range(FIT["iters"]))
    np.testing.assert_allclose([h[1:] for h in thist], [h[1:] for h in jhist], rtol=1e-5)


def test_fit_params_and_image_match_jax(fits):
    (jp, jimg, _), (tp, timg, _) = fits
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=5e-5)


def test_fit_keeps_every_depth_tied(fits):
    """z has no gradient under the orthographic projection, so Adam leaves
    it at exactly 1.0 in both packages."""
    (jp, _, _), (tp, _, _) = fits
    assert (jp["xyz"][:, 2] == 1.0).all() and (tp["xyz"][:, 2] == 1.0).all()


def jax_orbit(jmod, points: int, frames: int, size: int):
    """The JAX tutorial's render loop (`examples/gs_3d.py:main`), returning
    each view's output."""
    pos, col = jmod.make_torus(points)
    rng = np.random.RandomState(1)
    render = jlegacy.GaussianSplattingRender()
    render.active_sh_degree = 0
    outs = []
    for f in range(frames):
        theta = 2 * math.pi * f / frames
        outs.append(render.render_iter(
            FovX=math.pi / 3, FovY=math.pi / 3, height=size, width=size,
            world_view_transform=jnp.asarray(jmod.orbit_world_view(theta)), full_proj_transform=None,
            camera_center=jnp.zeros(3), position=jnp.asarray(pos), opacity=jnp.full((points,), 0.8),
            scaling=jnp.full((points, 3), 0.02),
            rotation=jnp.asarray(jquat_normalize(jnp.asarray(rng.randn(points, 4), jnp.float32))),
            shs=jnp.asarray(jmod.colors_to_shs(col))))
    return outs


def test_gs3d_inputs_match_jax(gs3d):
    jmod, tmod = gs3d
    for a, b in zip(tmod.make_torus(500), jmod.make_torus(500)):
        assert np.array_equal(a, b)
    col = jmod.make_torus(500)[1]
    assert np.array_equal(tmod.colors_to_shs(col), jmod.colors_to_shs(col))
    for f in range(12):
        theta = 2 * math.pi * f / 12
        assert np.array_equal(tmod.orbit_world_view(theta), jmod.orbit_world_view(theta)), f


def test_gs3d_views_match_jax(gs3d):
    jmod, tmod = gs3d
    want = jax_orbit(jmod, 2000, 3, 64)
    got = tmod.render_orbit(2000, 3, 64, device="cpu")
    for f, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["rgb"].numpy(), np.asarray(w["rgb"]), rtol=0, atol=2e-5, err_msg=f"view {f}")
        assert np.array_equal(g["radii"].numpy(), np.asarray(w["radii"])), f
        assert np.array_equal(g["visibility"].numpy(), np.asarray(w["visibility"])), f
        assert int(g["visibility"].sum()) > 0


@pytest.mark.parametrize("name,args", [
    ("torch_gs_2d", ["--points", "300", "--iters", "10", "--size", "32"]),
    ("torch_gs_3d", ["--points", "2000", "--frames", "2", "--size", "64"]),
])
def test_main_runs_on_the_cpu(name, args):
    load_example(name).main(args + ["--out", "", "--device", "cpu"])


@pytest.mark.parametrize("name", ["torch_gs_2d", "torch_gs_3d"])
def test_main_asks_for_a_gpu_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example(name).main(["--out", ""])
