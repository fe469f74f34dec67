"""XTC compressed-trajectory I/O over the host codec native/xtcio.cc —
PyTorch-port counterpart of gromacs_fep_gpu_tpu/io/xtcio.py
(write_xtc_frame, scan_xtc, read_xtc_frame; the 3dfcoord bit stream,
byte-identical to the reference's, reference: src/gromacs/fileio/xtcio.cpp
and libxdrf.cpp).  The codec is built with g++ at first use
(io/native.py)."""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from .native import fptr, library

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "xtc_write_frame": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_float, _FP, _FP, ctypes.c_float],
                        ctypes.c_int),
    "xtc_scan": ([ctypes.c_char_p, _IP, _IP], ctypes.c_int),
    "xtc_read_frame": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _FP,
                        _FP, _IP, _FP, _IP, _FP], ctypes.c_int),
}


def codec():
    """The loaded codec, built on first use (io/native.py)."""
    return library("xtcio", _SIGNATURES)


def write_xtc_frame(path: str, x: np.ndarray, box: np.ndarray,
                    step: int = 0, time: float = 0.0,
                    precision: float = 1000.0):
    """Append one compressed frame (x in nm, (N, 3); precision in 1/nm:
    1000 keeps 3 decimals, the GROMACS default)."""
    x = np.ascontiguousarray(x, np.float32)
    box9 = np.ascontiguousarray(box, np.float32).reshape(9)
    rc = codec().xtc_write_frame(path.encode(), x.shape[0], step, time,
                                fptr(box9), fptr(x), precision)
    if rc != 0:
        raise IOError(f"xtc write failed ({rc}) for {path}")


def scan_xtc(path: str) -> Tuple[int, int]:
    """(natoms, nframes)."""
    nf, na = ctypes.c_int(), ctypes.c_int()
    rc = codec().xtc_scan(path.encode(), ctypes.byref(nf), ctypes.byref(na))
    if rc != 0:
        raise IOError(f"xtc scan failed ({rc}) for {path}")
    return na.value, nf.value


def read_xtc_frame(path: str, index: int, natoms: int):
    """Frame `index`: dict with x, box (3, 3), step, time, precision; a
    frame of another atom count raises (of more atoms before the codec
    writes)."""
    x = np.zeros((natoms, 3), np.float32)
    box9 = np.zeros(9, np.float32)
    na, step = ctypes.c_int(), ctypes.c_int()
    t, prec = ctypes.c_float(), ctypes.c_float()
    rc = codec().xtc_read_frame(path.encode(), index, natoms, fptr(box9),
                               fptr(x), ctypes.byref(na), ctypes.byref(t),
                               ctypes.byref(step), ctypes.byref(prec))
    if rc != 0:
        raise IOError(f"xtc read failed ({rc}) for {path} frame {index}")
    if na.value != natoms:
        raise IOError(f"{path} frame {index}: {na.value} atoms, expected "
                      f"{natoms}")
    return {"x": x, "box": box9.reshape(3, 3), "step": step.value,
            "time": t.value, "precision": prec.value}
