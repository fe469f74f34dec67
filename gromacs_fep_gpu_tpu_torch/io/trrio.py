"""TRR trajectory I/O over the host codec native/trrio.cc — PyTorch-port
counterpart of gromacs_fep_gpu_tpu/io/trrio.py (write_trr_frame, scan_trr,
read_trr_frame; the same wire format, reference:
src/gromacs/fileio/trrio.cpp).  The codec is built with g++ at first use
(io/native.py).  Frames are numpy arrays: the caller copies the device
state to the host."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .native import fptr, library

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "trr_write_frame": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_float, ctypes.c_float, _FP, _FP, _FP, _FP],
                        ctypes.c_int),
    "trr_scan": ([ctypes.c_char_p, _IP, _IP], ctypes.c_int),
    "trr_read_frame": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _FP,
                        _FP, _FP, _FP, _IP, _FP, _FP, _IP, _IP, _IP],
                       ctypes.c_int),
}


def codec():
    """The loaded codec, built on first use (io/native.py)."""
    return library("trrio", _SIGNATURES)


def _f32(a):
    return None if a is None else np.ascontiguousarray(a, np.float32)


def write_trr_frame(path: str, x: np.ndarray, box: np.ndarray,
                    v: Optional[np.ndarray] = None,
                    f: Optional[np.ndarray] = None,
                    step: int = 0, time: float = 0.0, lam: float = 0.0):
    """Append one frame (x, v, f in nm, nm/ps, kJ/mol/nm, (N, 3); v and f
    optional)."""
    x, v, f = _f32(x), _f32(v), _f32(f)
    box9 = np.ascontiguousarray(box, np.float32).reshape(9)
    rc = codec().trr_write_frame(path.encode(), x.shape[0], step, time, lam,
                                fptr(box9), fptr(x), fptr(v), fptr(f))
    if rc != 0:
        raise IOError(f"trr write failed ({rc}) for {path}")


def scan_trr(path: str) -> Tuple[int, int]:
    """(natoms, nframes)."""
    na, nf = ctypes.c_int(), ctypes.c_int()
    rc = codec().trr_scan(path.encode(), ctypes.byref(na), ctypes.byref(nf))
    if rc != 0:
        raise IOError(f"trr scan failed ({rc}) for {path}")
    return na.value, nf.value


def read_trr_frame(path: str, index: int, natoms: int):
    """Frame `index`: dict with x, v, f (None where the frame has none),
    box (3, 3), step, time, lam; a frame of more than natoms atoms raises
    (the codec checks before it writes)."""
    x, v, f = (np.zeros((natoms, 3), np.float32) for _ in range(3))
    box9 = np.zeros(9, np.float32)
    step, t, lam = ctypes.c_int(), ctypes.c_float(), ctypes.c_float()
    hx, hv, hf = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = codec().trr_read_frame(path.encode(), index, natoms, fptr(box9),
                               fptr(x), fptr(v), fptr(f), ctypes.byref(step),
                               ctypes.byref(t), ctypes.byref(lam),
                               ctypes.byref(hx), ctypes.byref(hv),
                               ctypes.byref(hf))
    if rc != 0:
        raise IOError(f"trr read failed ({rc}) for {path} frame {index}")
    return {"x": x if hx.value else None, "v": v if hv.value else None,
            "f": f if hf.value else None, "box": box9.reshape(3, 3),
            "step": step.value, "time": t.value, "lam": lam.value}
