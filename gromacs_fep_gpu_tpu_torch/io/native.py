"""Build and load the host codecs of native/*.cc (trrio.cc, xtcio.cc).

Each source is compiled by g++ on first use into
gromacs_fep_gpu_tpu_torch/_build/, named by a hash of the source and the
flags, so a changed source is rebuilt and a stale library is never loaded.
The compiler writes a file of its own process and os.replace moves it into
place, so processes that build at the same time (test workers) never load a
half-written library.  Nothing is built at import time.  These are host
C++ (XDR byte order, the XTC bit stream), not device code: ops/cuda_lib.py
builds the CUDA kernels with nvcc, these need only g++.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "native"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def library(stem: str, signatures) -> ctypes.CDLL:
    """The loaded library of native/<stem>.cc, built on first use;
    signatures: {function: (argtypes, restype)}."""
    with _lock:
        lib = _libs.get(stem)
        if lib is not None:
            return lib
        src = SRC_DIR / f"{stem}.cc"
        tgt = _target(src)
        if not tgt.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = tgt.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o",
                                   str(tmp)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {src.name} (exit "
                                   f"{proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, tgt)
        lib = ctypes.CDLL(str(tgt))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[stem] = lib
        return lib


def fptr(a):
    """A float32 numpy array's data pointer (None passes NULL)."""
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
