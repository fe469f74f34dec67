"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into its own shared library with
a plain C interface and loaded with ctypes (no PyTorch headers, so a build
takes seconds).  All sources are compiled concurrently on first use, into
gromacs_fep_gpu_tpu_torch/_build/, named by a hash of the source so a
changed source is rebuilt.  Nothing is built at import time.

Every C entry point launches on the stream it is given, allocates nothing,
and returns cudaGetLastError() as an int; `check` raises on a non-zero
code.  There is no fallback: a missing nvcc, a failed build or a failed
launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("nb_v2u.cu", "nb_cluster.cu", "pme_spline.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point, by library
SIGNATURES = {
    "nb_v2u": {
        # K1 and K6: 3 plane rows, iq, is6, is12, plane cluster ids, shift
        # (or null), jq, js6, js12, pair/excl masks, ng, 3 force planes,
        # energies, box(9); i_off, S, G, split, coulomb type, energy flag,
        # virial flag, minimum-image flag; 8 float constants; stream
        "nb_v2u_launch": [_P] * 19 + [_I] * 8 + [_F] * 8 + [_P],
        # coulomb type, energy flag, virial flag, minimum-image flag
        "nb_v2u_ctas_per_sm": [_I] * 4,
    },
    "nb_cluster": {
        # every per-cluster layout: x, y, z, q, pv, s6, s12, types, nbfp,
        # excl, nbr, cnt, shift, jmask, 3 force planes, energies, box(9);
        # T, K, W, i0, n_icl, warps, layout, lj_table, flavour, coulomb
        # type, modifier; 16 float constants; stream
        "nb_table_launch": [_P] * 19 + [_I] * 11 + [_F] * 16 + [_P],
    },
    "pme_spline": {
        # x, q, box(9), grid; n, K1, K2, K3; stream
        "pme_spread_launch": [_P] * 4 + [_I] * 4 + [_P],
        # x, q, box(9), phi, forces (n, 3), dE/dq (n,); n, K1, K2, K3;
        # stream
        "pme_gather_launch": [_P] * 6 + [_I] * 4 + [_P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: float = 0.0
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return path


def _target(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no current library, all at once."""
    global build_seconds
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, out = {}, {}
    for name in SOURCES:
        src = SRC_DIR / name
        tgt = _target(src)
        out[src.stem] = tgt
        if not tgt.exists():
            tmp = tgt.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            todo[src.stem] = (tmp, tgt, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failed = []
    for stem, (tmp, tgt, proc) in todo.items():
        log, _ = proc.communicate()
        build_logs[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, tgt)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    build_seconds += time.perf_counter() - t0
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu, built on first use."""
    lib = _libs.get(stem)
    if lib is None:
        paths = build_all()
        for s, path in paths.items():
            if s not in _libs:
                cdll = ctypes.CDLL(str(path))
                for fn, argtypes in SIGNATURES[s].items():
                    getattr(cdll, fn).argtypes = argtypes
                    getattr(cdll, fn).restype = ctypes.c_int
                _libs[s] = cdll
        lib = _libs[stem]
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")
