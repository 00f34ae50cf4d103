"""Build the hand-written CUDA kernels of `csrc/` at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
into its own shared library, loaded with ctypes (no PyTorch headers, so a
build takes seconds). Libraries go into `splatter_a_video_tpu_torch/_build/`
(git-ignored), named by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and an
unchanged one is not. Several kernels are built in parallel, one nvcc
process each.

    python -m splatter_a_video_tpu_torch.ops._build --ptxas [FILE.cu ...]

compiles the given sources (by default those of `csrc/`) with the same
flags plus `-Xptxas -v` and prints ptxas's report: registers, spill
stores and loads, and static shared memory of every kernel instance. It
reads any source, such as an older tree's, and loads nothing: that is what
it adds to `rasterize_gpu.kernel_attributes`, which reports only the
instance a launch would run, and only for sources that export
`<name>_attributes`.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("blend_forward", "expand_intersections", "blend_backward", "reduce_gaussians", "ssim")
# --fmad=false: no contraction of a*b+c into one rounding, so each kernel
# rounds exactly like its plain PyTorch version (see csrc/blend_forward.cu).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    # every header of csrc/ goes into each hash: an edited header rebuilds
    # the kernels that include it
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Sequence[str] = KERNELS) -> float:
    """Compile the named kernels that are not built yet, all nvcc processes
    at once. Returns the seconds taken; raises with nvcc's stderr on failure."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for n, out, tmp, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for csrc/{n}.cu (exit {p.returncode}):\n{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def ptxas_report(sources: Sequence[Path]) -> str:
    """ptxas's `-v` report of each source, compiled to an object file in
    `_build/ptxas/` with the kernels' flags, all nvcc processes at once."""
    out_dir = BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = [
        (src, subprocess.Popen(
            [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(out_dir / f"{Path(src).stem}.o"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources
    ]
    report = []
    for src, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} (exit {p.returncode}):\n{text}")
        report.append(f"== {src}\n{text.strip()}")
    return "\n".join(report)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Report the registers, spills and shared memory of CUDA kernels.")
    ap.add_argument("--ptxas", nargs="*", metavar="FILE.cu", required=True,
                    help="print ptxas -v for these sources (default: every csrc/*.cu)")
    args = ap.parse_args()
    print(ptxas_report([Path(f) for f in args.ptxas] or [CSRC / f"{n}.cu" for n in KERNELS]))
