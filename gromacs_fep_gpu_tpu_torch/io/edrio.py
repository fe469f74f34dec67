"""GROMACS .edr energy-file codec (write + read), pure Python XDR —
PyTorch-port copy of gromacs_fep_gpu_tpu/io/edrio.py (EdrWriter, read_edr,
dhcoll_block, dh_block; numpy only).

Implements the enx format exactly as the reference serializes it
(reference: fileio/enxio.cpp — do_enxnms:386 names header with magic
-55555 / file_version 5, do_eheader:440 frame header with magic
-7777777, do_enx:959 energy records and blocks; block ids enxio.h:70;
XdrDataType fileio/xdr_datatype.h:39), including the BAR delta-H blocks
(enxDHCOLL collection metadata + per-series enxDH raw-data blocks,
reference: mdlib/mdebin_bar.cpp:216 mde_delta_h_handle_block, :629
mde_delta_h_coll_handle_block) that `gmx bar` post-processes.

Frames are written instantaneous-only (nsum == 1 -> the header stores 0
and no eav/esum pairs follow, matching the reference's "do not store
sums of length 1" rule, enxio.cpp:523-533,1039).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

ENX_VERSION = 5
MAGIC_NMS = -55555
MAGIC_FRAME = -7777777

# block ids (enxio.h:70 enum; order is the file format)
ENX_OR, ENX_ORI, ENX_ORT, ENX_DISRE, ENX_DHCOLL, ENX_DHHIST, ENX_DH, \
    ENX_AWH = range(8)

# XdrDataType (fileio/xdr_datatype.h:39)
XDR_INT, XDR_FLOAT, XDR_DOUBLE, XDR_INT64, XDR_CHAR, XDR_STRING = range(6)

# delta-H series types (mdlib/energyoutput.h:97 dhbt*)
DHBT_DH, DHBT_DHDL, DHBT_EN, DHBT_PV, DHBT_EXPANDED = range(5)


class _Xdr:
    """Minimal XDR encoder/decoder (big-endian, 4-byte aligned)."""

    def __init__(self, data: bytes = b""):
        self.buf = bytearray(data)
        self.pos = 0
        # reals are 8 bytes in files written by double-precision builds
        self.double = False

    # -- write ---------------------------------------------------------
    def w_int(self, v):
        self.buf += struct.pack(">i", int(v))

    def w_int64(self, v):
        self.buf += struct.pack(">q", int(v))

    def w_float(self, v):
        self.buf += struct.pack(">f", float(v))

    def w_double(self, v):
        self.buf += struct.pack(">d", float(v))

    def w_floats(self, a):
        self.buf += np.asarray(a, ">f4").tobytes()

    def w_doubles(self, a):
        self.buf += np.asarray(a, ">f8").tobytes()

    def w_ints(self, a):
        self.buf += np.asarray(a, ">i4").tobytes()

    def w_int64s(self, a):
        self.buf += np.asarray(a, ">i8").tobytes()

    def w_string(self, s: str):
        # xdr_string counted-string: strlen (no terminator) + padded bytes
        # (reference: fileio/gmx_internal_xdr.cpp:390)
        b = s.encode()
        self.w_int(len(b))
        pad = (4 - len(b) % 4) % 4
        self.buf += b + b"\x00" * pad

    # -- read ----------------------------------------------------------
    def _take(self, n):
        v = bytes(self.buf[self.pos:self.pos + n])
        if len(v) < n:
            raise EOFError("edr: truncated stream")
        self.pos += n
        return v

    def r_int(self):
        return struct.unpack(">i", self._take(4))[0]

    def r_int64(self):
        return struct.unpack(">q", self._take(8))[0]

    def r_float(self):
        return struct.unpack(">f", self._take(4))[0]

    def r_double(self):
        return struct.unpack(">d", self._take(8))[0]

    def r_floats(self, n):
        return np.frombuffer(self._take(4 * n), ">f4").astype(np.float64)

    def r_doubles(self, n):
        return np.frombuffer(self._take(8 * n), ">f8").astype(np.float64)

    def r_ints(self, n):
        return np.frombuffer(self._take(4 * n), ">i4").astype(np.int64)

    def r_int64s(self, n):
        return np.frombuffer(self._take(8 * n), ">i8").astype(np.int64)

    def r_real(self):
        return self.r_double() if self.double else self.r_float()

    def r_string(self):
        n = self.r_int()
        pad = (4 - n % 4) % 4
        raw = self._take(n + pad)[:n]
        return raw.rstrip(b"\x00").decode(errors="replace")

    def eof(self):
        return self.pos >= len(self.buf)


@dataclass
class EdrBlock:
    id: int
    subs: List[Tuple[int, np.ndarray]] = field(default_factory=list)
    # each sub: (xdr_type, values)


@dataclass
class EdrFrame:
    t: float
    step: int
    ener: np.ndarray                 # (nre,)
    blocks: List[EdrBlock] = field(default_factory=list)
    dt: float = 0.0
    nsteps: int = 1


def _write_sub(x: _Xdr, typ: int, vals):
    if typ == XDR_FLOAT:
        x.w_floats(vals)
    elif typ == XDR_DOUBLE:
        x.w_doubles(vals)
    elif typ == XDR_INT:
        x.w_ints(vals)
    elif typ == XDR_INT64:
        x.w_int64s(vals)
    else:
        raise ValueError(f"edr write: unsupported subblock type {typ}")


def _read_sub(x: _Xdr, typ: int, n: int):
    if typ == XDR_FLOAT:
        return x.r_floats(n)
    if typ == XDR_DOUBLE:
        return x.r_doubles(n)
    if typ == XDR_INT:
        return x.r_ints(n)
    if typ == XDR_INT64:
        return x.r_int64s(n)
    raise ValueError(f"edr read: unsupported subblock type {typ}")


class EdrWriter:
    """Streaming .edr writer (open once, add frames, close)."""

    def __init__(self, path: str, names: Sequence[str],
                 units: Optional[Sequence[str]] = None):
        self.path = path
        self.names = list(names)
        self.units = list(units) if units is not None else \
            ["kJ/mol"] * len(self.names)
        x = _Xdr()
        x.w_int(MAGIC_NMS)
        x.w_int(ENX_VERSION)
        x.w_int(len(self.names))
        for nm, un in zip(self.names, self.units):
            x.w_string(nm)
            x.w_string(un)
        self._fh = open(path, "wb")
        self._fh.write(bytes(x.buf))

    def write_frame(self, frame: EdrFrame):
        x = _Xdr()
        x.w_float(-2e10)                       # first_real_to_check
        x.w_int(MAGIC_FRAME)
        x.w_int(ENX_VERSION)
        x.w_double(frame.t)
        x.w_int64(frame.step)
        x.w_int(0)                             # nsum==1 -> stored as 0
        x.w_int64(frame.nsteps)
        x.w_double(frame.dt)
        x.w_int(len(frame.ener))
        x.w_int(0)                             # reserved (was ndisre)
        x.w_int(len(frame.blocks))
        for blk in frame.blocks:
            x.w_int(blk.id)
            x.w_int(len(blk.subs))
            for typ, vals in blk.subs:
                x.w_int(typ)
                x.w_int(len(np.atleast_1d(vals)))
        x.w_int(len(frame.ener) * 4 * 4)       # e_size
        x.w_int(0)
        x.w_int(0)
        x.w_floats(frame.ener)                 # instantaneous only
        for blk in frame.blocks:
            for typ, vals in blk.subs:
                _write_sub(x, typ, np.atleast_1d(vals))
        self._fh.write(bytes(x.buf))

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_edr(path: str):
    """-> (names, units, frames: List[EdrFrame])."""
    x = _Xdr(open(path, "rb").read())
    if x.r_int() != MAGIC_NMS:
        raise ValueError("not a GROMACS edr file (names magic mismatch)")
    ver = x.r_int()
    if ver > ENX_VERSION:
        raise ValueError(f"edr file_version {ver} > supported {ENX_VERSION}")
    nre = x.r_int()
    names, units = [], []
    for _ in range(nre):
        names.append(x.r_string())
        units.append(x.r_string() if ver >= 2 else "kJ/mol")
    frames = []
    # precision detection (reference: enxio.cpp do_eheader magic real
    # -2e10): try the first frame's leading real as float, else double
    if not x.eof():
        p0 = x.pos
        f4 = x.r_float()
        x.pos = p0
        if not (f4 <= -1e10):
            f8 = x.r_double()
            x.pos = p0
            if f8 <= -1e10:
                x.double = True
    while not x.eof():
        first = x.r_real()
        if first > -1e10:
            raise ValueError("edr: old (version-1) frames not supported")
        if x.r_int() != MAGIC_FRAME:
            raise ValueError("edr: frame magic mismatch")
        fver = x.r_int()
        t = x.r_double()
        step = x.r_int64()
        nsum = x.r_int()
        nsteps = x.r_int64() if fver >= 3 else max(1, nsum)
        dt = x.r_double() if fver >= 5 else 0.0
        fnre = x.r_int()
        x.r_int()                              # reserved
        nblock = x.r_int()
        blocks = []
        for _ in range(nblock):
            bid = x.r_int()
            nsub = x.r_int()
            subs_hdr = [(x.r_int(), x.r_int()) for _ in range(nsub)]
            blocks.append((bid, subs_hdr))
        x.r_int()                              # e_size
        x.r_int()
        x.r_int()
        ener = np.zeros(fnre)
        for i in range(fnre):
            ener[i] = x.r_real()
            if nsum > 1:
                x.r_real()                     # eav
                x.r_real()                     # esum
        out_blocks = []
        for bid, subs_hdr in blocks:
            blk = EdrBlock(id=bid)
            for typ, n in subs_hdr:
                blk.subs.append((typ, _read_sub(x, typ, n)))
            out_blocks.append(blk)
        frames.append(EdrFrame(t=t, step=step, ener=ener,
                               blocks=out_blocks, dt=dt, nsteps=nsteps))
    return names, units, frames


# ---------------------------------------------------------------------------
# delta-H (BAR) block builders — mdlib/mdebin_bar.cpp layout
# ---------------------------------------------------------------------------

def dhcoll_block(temperature: float, start_time: float, delta_time: float,
                 start_lambda: float, lambda_index: int = -1,
                 native_lambda_vec: Optional[Sequence[float]] = None,
                 lambda_components: Optional[Sequence[int]] = None
                 ) -> EdrBlock:
    """enxDHCOLL collection metadata (mdebin_bar.cpp:629): sub[0] doubles
    [T, t0, dt, lambda0, dlambda, lambda-vec...]; sub[1] ints
    [lambda_index, n_components, component ids...] when vectors used."""
    d = [temperature, start_time, delta_time, start_lambda, 0.0]
    blk = EdrBlock(id=ENX_DHCOLL)
    if native_lambda_vec is not None:
        d = d + [float(v) for v in native_lambda_vec]
        blk.subs.append((XDR_DOUBLE, np.asarray(d)))
        comp = list(lambda_components or range(len(native_lambda_vec)))
        ii = [int(lambda_index), len(native_lambda_vec)] + \
            [int(c) for c in comp]
        blk.subs.append((XDR_INT, np.asarray(ii)))
    else:
        blk.subs.append((XDR_DOUBLE, np.asarray(d)))
    return blk


def dh_block(series_type: int, samples, foreign_lambda=(),
             derivative: int = 0) -> EdrBlock:
    """One enxDH raw-data series (mdebin_bar.cpp:216): sub[0] int
    [type, derivative]; sub[1] double foreign-lambda (empty for
    dhdl/energy/pV series); sub[2] float samples."""
    blk = EdrBlock(id=ENX_DH)
    blk.subs.append((XDR_INT, np.asarray([series_type, derivative])))
    blk.subs.append((XDR_DOUBLE, np.atleast_1d(
        np.asarray(foreign_lambda, np.float64))))
    blk.subs.append((XDR_FLOAT, np.asarray(samples, np.float32)))
    return blk
