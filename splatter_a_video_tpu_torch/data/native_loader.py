"""ctypes binding of the native track loader `native/sav_loader.cpp`
(counterpart of `splatter_a_video_tpu/data/native_loader.py`).

The loader memory-maps a clip's per-pair track files `<q>_<t>.npy` and
assembles each step's track batch in C++: a splitmix64 partial
Fisher-Yates draw of P rows, seeded per step. `BatchBuilder` engages it
for on-disk clips exactly as the JAX package does, so both packages draw
the same rows.

The library is built with g++ on first use into the port's git-ignored
`_build/`, named by a hash of the source and the flags. The JAX package's
build target `native/libsav_loader.so` is never written or loaded here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "sav_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"sav_loader-{digest}.so"


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if g++ or the
    source is missing or the build fails (callers check `available()`)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.sav_open_clip.restype = ctypes.c_void_p
    lib.sav_open_clip.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.sav_close_clip.argtypes = [ctypes.c_void_p]
    lib.sav_num_tracks.restype = ctypes.c_int64
    lib.sav_num_tracks.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.sav_build_batch.restype = ctypes.c_int64
    lib.sav_build_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeTrackLoader:
    """mmap-backed per-pair track batch assembly."""

    def __init__(self, tracks_dir: str, frame_names: List[str]):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable (g++ build failed?)")
        self._lib = lib
        self._handle = lib.sav_open_clip(str(tracks_dir).encode(), "\n".join(frame_names).encode())
        if not self._handle:
            raise RuntimeError("sav_open_clip failed")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.sav_close_clip(self._handle)
            self._handle = None

    def num_tracks(self, q: int, t: int) -> int:
        return int(self._lib.sav_num_tracks(self._handle, q, t))

    def build(self, q: int, t: int, P: int, seed: int):
        """Returns (query_px [P,2], target_tracks [P,4], valid [P] bool)."""
        qbuf = np.empty((P, 2), np.float32)
        tbuf = np.empty((P, 4), np.float32)
        vbuf = np.empty((P,), np.float32)
        ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        n = self._lib.sav_build_batch(self._handle, q, t, P, seed, ptr(qbuf), ptr(tbuf), ptr(vbuf))
        if n < 0:
            raise RuntimeError(f"sav_build_batch({q},{t}) failed")
        return qbuf, tbuf, vbuf > 0.5
