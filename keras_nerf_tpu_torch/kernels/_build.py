"""Build the CUDA sources of this package into one shared library.

Route: ``nvcc`` compiles every ``csrc/*.cu`` into an object (one compiler
process per source, all started together), links them into
``build/kernels/<hash>/libknt_kernels.so`` at the repository root and the
library is bound with :mod:`ctypes`. The sources have a plain C interface
and include no PyTorch header, so a build takes seconds, not the minutes of
``torch.utils.cpp_extension.load``. The build directory is keyed by a hash
of the sources and flags, so an edited source never loads a stale library.

Nothing here runs at import time: the first kernel launch calls
:func:`load`. A missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libknt_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]


@dataclasses.dataclass(frozen=True)
class BuildResult:
    """The loaded library plus what its build printed and took."""

    lib: ctypes.CDLL
    path: Path
    log: str
    seconds: float
    cached: bool


_RESULT: BuildResult | None = None


def find_nvcc() -> str:
    """``nvcc`` from ``$PATH``, else under PyTorch's detected CUDA home."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is not None:
            cand = Path(CUDA_HOME) / "bin" / "nvcc"
            if cand.exists():
                nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): the "
            "CUDA kernels of keras_nerf_tpu_torch cannot be built")
    return nvcc


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"CUDA kernel build failed ({' '.join(cmd)}):\n{out}")
    return out


def build() -> BuildResult:
    """Compile (unless a library for these exact sources exists) and load."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    t0 = time.perf_counter()
    cached = lib_path.exists()
    if cached:
        log = log_path.read_text() if log_path.exists() else ""
    else:
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        srcs = sources()
        # Per-process names: processes that build at once never share a
        # file until the atomic rename of the finished library.
        pid = os.getpid()
        objs = [out_dir / f"{s.stem}.{pid}.o" for s in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                for s, o in zip(srcs, objs)]
        with ThreadPoolExecutor(max_workers=max(1, len(cmds))) as pool:
            logs = list(pool.map(_run, cmds))
        tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
        logs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs)]))
        for o in objs:
            o.unlink()
        os.replace(tmp, lib_path)
        log = "".join(f"== {s.name}\n{text}" for s, text in
                      zip([*srcs, Path("link")], logs))
        log_path.write_text(log)
    lib = ctypes.CDLL(str(lib_path))
    return BuildResult(lib, lib_path, log, time.perf_counter() - t0, cached)


def load() -> ctypes.CDLL:
    """The kernel library of this process, built on first use."""
    global _RESULT
    if _RESULT is None:
        _RESULT = build()
        _declare(_RESULT.lib)
    return _RESULT.lib


def last_build() -> BuildResult | None:
    return _RESULT


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The argument types of every C entry point; each returns an int.
ENTRY_POINTS = {
    "knt_sample_merge": [_P, _I, _P, _P, _P, _P] + [_I] * 6 + [_P],
    "knt_ray_march_mlp": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "knt_ray_march_mlp_persistent": [_P] * 6 + [_I, _I, _I, _P],
    "knt_ray_march_quadrature": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _P],
    "knt_ray_march_quadrature_grad": [_P] * 8 + [_I, _I, _I, _F, _I, _P],
    "knt_apply_mlp": [_P, _P, _P, _I, _P, _P],
    "knt_mlp_backward": [_P, _P, _P, _P, _P, _I, _P],
    "knt_mlp_backward_from_output": [_P] * 6 + [_I, _P],
    "knt_mlp_weight_grad": [_P, _I, _P, _I, _I, _I, _I, _P, _P],
    "knt_ray_march_mlp_int8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "knt_mma_ceiling": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # The streamed routes and the device tables of tensor maps they read.
    "knt_encode_maps": [_P, _I, _P],
    "knt_mlp_streamed": [_P, _I, _I] + [_P] * 6 + [_I, _I, _I, _P, _I, _P,
                                                   _P, _P],
    "knt_mlp_backward_streamed": [_P, _I, _I] + [_P] * 9 + [_I, _P],
    "knt_ray_march_mlp_int8_streamed": [_P, _I, _I] + [_P] * 5
    + [_I, _I, _I, _P, _P],
}


def _declare(lib: ctypes.CDLL, names=ENTRY_POINTS) -> None:
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = ENTRY_POINTS[name]
        fn.restype = _I


def build_single(source: Path, out_dir: Path, names,
                 defines=()) -> ctypes.CDLL:
    """One ``.cu`` file (of this or another checkout) compiled alone with
    this package's flags into a library of its own, its C entry points
    ``names`` declared as :func:`load` declares them: the timing tools
    launch another build of a kernel through this package's wrappers.
    ``defines`` adds ``-D`` macros (``profile_ablate``'s ``KNT_ABL_*``
    builds; :func:`load` never passes one). What the compiler printed
    (``-Xptxas -v``) goes to ``build.log`` beside it."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{source.stem}.so"
    (out_dir / "build.log").write_text(_run(
        [find_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-shared",
         "-o", str(lib_path), str(source)]))
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib, names)
    return lib
