"""Port parity of the native track loader: on an on-disk clip the port's
`BatchBuilder` engages its own build of `native/sav_loader.cpp` on the
JAX package's condition and draws the per-step seed in the JAX order, so
both packages' batches are byte-identical, subsampled and padded.

The JAX side runs its own `BatchBuilder` and loader binding over the
port's build of the same source: the JAX package's `_load` rebuilds the
tracked `native/libsav_loader.so` in place when it is older than the
source (as in a fresh checkout), which another test worker may be doing
or loading at the same moment. The port's build is checked, on a copy of
`native/`, to write only its own hash-named library and never the JAX
package's `libsav_loader.so`."""

import hashlib
import os
import pathlib
import shutil

import numpy as np
import pytest

from splatter_a_video_tpu.data import native_loader as jnl
from splatter_a_video_tpu.data import pairs as jpairs
from splatter_a_video_tpu.data import video_flow as jvf
from splatter_a_video_tpu.train import trainer as jtr
from splatter_a_video_tpu_torch.data import native_loader as tnl
from splatter_a_video_tpu_torch.data import pairs as tpairs
from splatter_a_video_tpu_torch.data import video_flow as tvf

ROOT = pathlib.Path(__file__).resolve().parent.parent
T, N, H, W = 4, 37, 8, 8
PAIRS = [(0, 2), (1, 3), (3, 0), (2, 2), (1, 3)]


@pytest.fixture(scope="module")
def track_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracks")
    rng = np.random.RandomState(0)
    names = [f"{i:05d}" for i in range(T)]
    for q in range(T):
        for t in range(T):
            arr = rng.rand(N, 4).astype(np.float32) * 50
            if q == t:
                arr[:, 2:] = -8.0  # self-tracks: visible
            np.save(os.path.join(str(d), f"{names[q]}_{names[t]}.npy"), arr)
    return str(d), names


def _clip(vf, d, names):
    return vf.VideoFlowData(
        frames=[np.zeros((H, W, 3), np.float32)] * T,
        depths_raw=[np.ones((H, W), np.float32)] * T,
        masks_raw=[np.zeros((H, W), bool)] * T,
        tracks=None, frame_names=names, tracks_dir=d,
    ).setup()


@pytest.fixture
def jax_on_port_build(monkeypatch):
    """The JAX package's loader binding over the port's build."""
    assert tnl.available()
    monkeypatch.setattr(jnl, "_LIB", tnl._load())


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_port_build_leaves_the_jax_library_alone(tmp_path, monkeypatch):
    native = tmp_path / "native"
    shutil.copytree(ROOT / "native", native)
    jax_lib = native / "libsav_loader.so"
    os.utime(jax_lib, (1, 1))   # older than the source, as the JAX loader would rebuild it
    before = (_digest(jax_lib), jax_lib.stat().st_mtime_ns, sorted(os.listdir(native)))
    monkeypatch.setattr(tnl, "SOURCE", native / "sav_loader.cpp")
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnl, "_LIB", None)
    monkeypatch.setattr(tnl, "_TRIED", False)
    assert tnl.available()
    assert (_digest(jax_lib), jax_lib.stat().st_mtime_ns, sorted(os.listdir(native))) == before
    built = sorted(os.listdir(tmp_path / "_build"))
    assert built == [tnl.library_path().name] and built[0].startswith("sav_loader-")


@pytest.mark.parametrize("slim", [True, False], ids=["slim", "full"])
@pytest.mark.parametrize("P", [16, N + 11], ids=["subsampled", "padded"])
def test_batches_equal_on_disk(track_dir, P, slim, jax_on_port_build):
    d, names = track_dir
    jb = jpairs.BatchBuilder(_clip(jvf, d, names), P, seed=3, slim=slim)
    tb = tpairs.BatchBuilder(_clip(tvf, d, names), P, seed=3, slim=slim)
    assert jb._native is not None and tb._native is not None
    for t1, t2 in PAIRS:
        a, b = jb.build(t1, t2), tb.build(t1, t2)
        for f in jtr.Batch._fields[2:]:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), (f, t1, t2)
    assert np.array_equal(jb.rng.randint(0, 2**31, 4), tb.rng.randint(0, 2**31, 4))


def test_in_memory_and_opt_out_take_the_numpy_path(track_dir):
    d, names = track_dir
    assert tpairs.BatchBuilder(_clip(tvf, d, names), 16, use_native=False)._native is None
    clip = _clip(tvf, d, names)
    jclip = _clip(jvf, d, names)
    jb = jpairs.BatchBuilder(jclip, 16, seed=1, use_native=False)
    tb = tpairs.BatchBuilder(clip, 16, seed=1, use_native=False)
    for t1, t2 in PAIRS:
        assert np.array_equal(jb.build(t1, t2).target_tracks, tb.build(t1, t2).target_tracks)


def test_loader_rows_are_real_pairs(track_dir):
    d, names = track_dir
    ld = tnl.NativeTrackLoader(d, names)
    assert ld.num_tracks(0, 3) == N
    qp, tt, valid = ld.build(1, 3, 16, seed=42)
    assert valid.all() and len(np.unique(qp, axis=0)) == 16
    tgt = np.load(os.path.join(d, f"{names[1]}_{names[3]}.npy"))
    assert all((np.abs(tgt - row) < 1e-6).all(axis=1).any() for row in tt)
    qp, tt, valid = ld.build(0, 2, N + 10, seed=7)
    assert valid.sum() == N and (qp[N:] == 0).all() and (tt[N:] == 0).all()
