"""GROMACS .cpt checkpoint interop (read + write) — PyTorch-port copy of
gromacs_fep_gpu_tpu/io/cptio.py (write_gmx_cpt, is_gmx_cpt, read_gmx_cpt;
numpy only).  A restart between the two packages goes through this
format, which both read.

Reference: src/gromacs/fileio/checkpoint.cpp —
  do_cpt_header (:1095, magic 171817, version-gated fields),
  do_cpt_state (:1316, StateEntry bit flags, each entry stored as the
  self-describing [int32 count][int32 XdrDataType][payload] record of
  doVectorLow :719),
  do_cpt_ekinstate (:1424), do_cpt_enerhist (:1625),
  do_cpt_files (:2246), do_cpt_footer (:1294, magic 171819),
  write_checkpoint_data (:2333, section order incl. the MDModules and
  modular-simulator KV trees, keyvaluetreeserializer.cpp tags),
  xdr_int64 split into high/low int32 (fileio/xdrd.cpp:107),
  StateEntry order mdtypes/state.h:95.

Everything is big-endian XDR.  File version written: CurrentVersion
(= 23, AwhLocalWeightSum) of the 2023 tree.  The reader accepts any
file version >= LambdaStateAndHistory (14, GROMACS 4.6+) and fails
loudly on sections whose flags it does not implement (pull history /
expanded dfhist / ED / swap / AWH), which are absent for plain md runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

CPT_MAGIC1 = 171817
CPT_MAGIC2 = 171819
CPT_VERSION = 23          # CheckPointVersion::CurrentVersion (2023.x)
# version gates used below (checkpoint.h enum)
V_SAFE_SIM_PART = 3
V_EKIN_FLAGS = 4
V_SAFE_STEPS = 5
V_FILE_CHECKSUM = 8
V_NH_THERMOSTAT = 10
V_NH_BAROSTAT = 11
V_HOST_INFO = 12
V_DOUBLE_PREC = 13
V_LAMBDA_HISTORY = 14
V_ESSENTIAL_DYNAMICS = 15
V_SWAP_STATE = 16
V_AWH_FLAGS = 17
V_NO_BUILD_INFO = 18
V_MDMODULES = 21
V_MODULAR_SIM = 22

XDR_INT, XDR_FLOAT, XDR_DOUBLE = 0, 1, 2   # fileio/xdr_datatype.h
_XDR_DTYPE = {XDR_INT: ">i4", XDR_FLOAT: ">f4", XDR_DOUBLE: ">f8"}

# StateEntry order (mdtypes/state.h:95); kind is how do_cpt_state stores
# it — every kind below is a self-describing [count][type][payload]
# record; "f" real(s), "d" double(s), "i" int(s)
STATE_ENTRIES = [
    ("lambda", "f"), ("box", "f"), ("box_rel", "f"), ("boxv", "f"),
    ("pres_prev", "f"), ("nosehoover_xi", "d"), ("therm_integral", "d"),
    ("x", "f"), ("v", "f"), ("sdx_unsup", "f"), ("cg_p", "f"),
    ("ld_rng_unsup", "i"), ("ld_rngi_unsup", "i"),
    ("disre_initf", "f"), ("disre_rm3tav", "f"),
    ("orire_initf", "f"), ("orire_dtav", "f"),
    ("svir_prev", "f"), ("nosehoover_vxi", "d"), ("veta", "f"),
    ("vol0", "f"), ("nhpres_xi", "d"), ("nhpres_vxi", "d"),
    ("fvir_prev", "f"), ("fep_state", "i"), ("mc_rng_unsup", "i"),
    ("mc_rngi_unsup", "i"), ("baros_integral", "d"),
    ("pull_com_prev_step", "d"),
]
_STATE_BIT = {name: i for i, (name, _) in enumerate(STATE_ENTRIES)}


class XdrWriter:
    def __init__(self):
        self.buf = bytearray()

    def i32(self, v: int):
        self.buf += int(v).to_bytes(4, "big", signed=True)

    def u32(self, v: int):
        self.buf += int(v).to_bytes(4, "big", signed=False)

    def i64(self, v: int):
        v = int(v)
        self.i32((v >> 32) & 0xFFFFFFFF if v >= 0 else (v >> 32))
        self.u32(v & 0xFFFFFFFF)

    def f64(self, v: float):
        self.buf += np.array(v, ">f8").tobytes()

    def string(self, s: str):
        """Plain xdr_string: [len][bytes padded to 4]."""
        b = s.encode()
        self.u32(len(b))
        self.buf += b + b"\x00" * (-len(b) % 4)

    def record(self, values, xdr_type: int):
        """doVectorLow: [count][XdrDataType][payload]."""
        a = np.asarray(values).reshape(-1)
        self.i32(a.size)
        self.i32(xdr_type)
        self.buf += np.ascontiguousarray(a, _XDR_DTYPE[xdr_type]).tobytes()


class XdrReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("cpt: truncated file")
        b = self.data[self.pos: self.pos + n]
        self.pos += n
        return b

    def i32(self) -> int:
        return int.from_bytes(self._take(4), "big", signed=True)

    def u32(self) -> int:
        return int.from_bytes(self._take(4), "big", signed=False)

    def i64(self) -> int:
        hi = self.i32()
        lo = self.u32()
        return (hi << 32) | lo

    def f64(self) -> float:
        return float(np.frombuffer(self._take(8), ">f8")[0])

    def string(self) -> str:
        n = self.u32()
        b = self._take((n + 3) // 4 * 4)
        return b[:n].split(b"\x00")[0].decode("utf-8", "replace")

    def record(self) -> np.ndarray:
        n = self.i32()
        t = self.i32()
        if t not in _XDR_DTYPE:
            raise ValueError(f"cpt: unknown XdrDataType {t}")
        itemsize = 8 if t == XDR_DOUBLE else 4
        return np.frombuffer(self._take(n * itemsize), _XDR_DTYPE[t])


@dataclasses.dataclass
class GmxCheckpoint:
    """Decoded contents of a GROMACS checkpoint."""
    version_string: str
    file_version: int
    double_prec: int
    natoms: int
    ngtc: int
    nhchainlength: int
    nnhpres: int
    nlambda: int
    integrator: int
    simulation_part: int
    step: int
    t: float
    flags_state: int
    state: Dict[str, np.ndarray]
    output_files: List[Tuple[str, int]]

    def get(self, name: str) -> Optional[np.ndarray]:
        return self.state.get(name)


def _header_fields(w: XdrWriter, *, natoms, ngtc, nhchainlength, nnhpres,
                   nlambda, integrator, simulation_part, step, t,
                   flags_state, version_string):
    w.i32(CPT_MAGIC1)
    w.string(version_string)
    w.string("")                     # build time UNUSED
    w.string("")                     # build user UNUSED
    w.string("")                     # build host UNUSED
    w.string("tpumd mdrun")          # generating program
    w.string("")                     # generation time
    w.i32(CPT_VERSION)
    w.i32(0)                         # double precision build
    w.string("localhost")            # generating host
    w.i32(natoms)
    w.i32(ngtc)
    w.i32(nhchainlength)
    w.i32(nnhpres)
    w.i32(nlambda)
    w.i32(integrator)
    w.i32(simulation_part)
    w.i64(step)
    w.f64(t)
    w.i32(1)                         # PP ranks
    w.i32(1)                         # dd_nc x
    w.i32(1)                         # dd_nc y
    w.i32(1)                         # dd_nc z
    w.i32(-1)                        # PME-only ranks (auto)
    w.i32(flags_state)
    w.i32(0)                         # ekin flags
    w.i32(0)                         # energy-history flags
    w.i32(0)                         # df-history flags
    w.i32(0)                         # ED data sets
    w.i32(0)                         # swap = SwapType::No
    w.i32(0)                         # AWH flags
    w.i32(0)                         # pull-history flags
    w.i32(0)                         # modular-simulator checkpoint: false


def write_gmx_cpt(path: str, *, x: np.ndarray, v: np.ndarray,
                  box: np.ndarray, lam: np.ndarray, fep_state: int,
                  step: int, t: float, nosehoover_xi=None,
                  nosehoover_vxi=None, therm_integral=None, boxv=None,
                  baros_integral: float = 0.0, integrator: int = 0,
                  simulation_part: int = 1,
                  version_string: str = "GROMACS 2023.3"):
    """Write a GROMACS-format checkpoint of the core MD state.

    Sections with dynamics-history flags (ekin, energy history, pull,
    expanded-ensemble dfhist, AWH) are written empty/zero-flagged —
    GROMACS recomputes kinetic data on restart when flags_eks == 0."""
    natoms = int(np.asarray(x).shape[0])
    lam = np.asarray(lam, np.float32).reshape(-1)
    ngtc = 1
    nhchainlength = (len(np.asarray(nosehoover_xi).reshape(-1))
                     if nosehoover_xi is not None else 1)

    entries: Dict[str, np.ndarray] = {"lambda": lam,
                                      "box": np.asarray(box, np.float32)}
    if boxv is not None:
        entries["boxv"] = np.asarray(boxv, np.float32)
    if nosehoover_xi is not None:
        entries["nosehoover_xi"] = np.asarray(nosehoover_xi, np.float64)
        entries["nosehoover_vxi"] = np.asarray(
            nosehoover_vxi if nosehoover_vxi is not None
            else np.zeros_like(nosehoover_xi), np.float64)
    if therm_integral is not None:
        entries["therm_integral"] = np.asarray([therm_integral],
                                               np.float64)
    entries["x"] = np.asarray(x, np.float32)
    if v is not None:
        entries["v"] = np.asarray(v, np.float32)
    entries["fep_state"] = np.asarray([fep_state], np.int32)
    if baros_integral != 0.0:
        entries["baros_integral"] = np.asarray([baros_integral],
                                               np.float64)

    flags = 0
    for name in entries:
        flags |= 1 << _STATE_BIT[name]

    w = XdrWriter()
    _header_fields(w, natoms=natoms, ngtc=ngtc,
                   nhchainlength=nhchainlength, nnhpres=0,
                   nlambda=0, integrator=integrator,
                   simulation_part=simulation_part, step=step, t=t,
                   flags_state=flags, version_string=version_string)
    # state section, in StateEntry enum order
    for name, kind in STATE_ENTRIES:
        if name not in entries:
            continue
        xt = {"f": XDR_FLOAT, "d": XDR_DOUBLE, "i": XDR_INT}[kind]
        w.record(entries[name], xt)
    # ekinstate/enerhist/pullhist/dfhist: flags 0 -> empty sections
    # EDstate: nED 0, swap: No, awh: flags 0 -> empty
    w.i32(0)                         # do_cpt_files: number of output files
    w.i32(0)                         # MDModules KV tree: 0 properties
    w.i32(0)                         # modular-simulator KV tree: empty
    w.i32(CPT_MAGIC2)                # footer
    with open(path, "wb") as f:
        f.write(bytes(w.buf))


def is_gmx_cpt(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return int.from_bytes(f.read(4), "big", signed=True) \
                == CPT_MAGIC1
    except OSError:
        return False


def read_gmx_cpt(path: str) -> GmxCheckpoint:
    r = XdrReader(open(path, "rb").read())
    if r.i32() != CPT_MAGIC1:
        raise ValueError(f"{path}: not a GROMACS checkpoint "
                         "(bad magic)")
    version_string = r.string()
    for _ in range(3):
        r.string()                   # btime/buser/bhost UNUSED
    r.string()                       # generating program
    r.string()                       # generation time
    fv = r.i32()
    if fv < V_LAMBDA_HISTORY:
        raise ValueError(f"{path}: checkpoint version {fv} too old "
                         "(need >= 14, GROMACS 4.6)")
    if fv > CPT_VERSION:
        raise ValueError(f"{path}: checkpoint version {fv} newer than "
                         f"supported {CPT_VERSION}")
    double_prec = r.i32() if fv >= V_DOUBLE_PREC else -1
    if fv >= V_HOST_INFO:
        r.string()                   # generating host
    natoms = r.i32()
    ngtc = r.i32()
    nhchainlength = r.i32() if fv >= V_NH_THERMOSTAT else 1
    nnhpres = r.i32() if fv >= V_NH_BAROSTAT else 0
    nlambda = r.i32()
    integrator = r.i32()
    simulation_part = r.i32() if fv >= V_SAFE_SIM_PART else 1
    step = r.i64() if fv >= V_SAFE_STEPS else r.i32()
    t = r.f64()
    r.i32()                          # PP ranks
    for _ in range(3):
        r.i32()                      # dd_nc
    r.i32()                          # PME ranks
    flags_state = r.i32()
    flags_eks = r.i32() if fv >= V_EKIN_FLAGS else 0
    flags_enh = r.i32() if fv >= V_EKIN_FLAGS else 0
    flags_dfh = r.i32()
    nED = r.i32() if fv >= V_ESSENTIAL_DYNAMICS else 0
    eSwap = r.i32() if fv >= V_SWAP_STATE else 0
    flags_awhh = r.i32() if fv >= V_AWH_FLAGS else 0
    flags_pullhist = r.i32() if fv >= V_NO_BUILD_INFO else 0
    if fv >= V_MODULAR_SIM:
        r.i32()                      # isModularSimulatorCheckpoint

    # --- state section: each flagged StateEntry is one self-describing
    # record (doVectorLow layout) ---
    state: Dict[str, np.ndarray] = {}
    for i, (name, _kind) in enumerate(STATE_ENTRIES):
        if flags_state & (1 << i):
            state[name] = r.record()
    for nm in ("box", "box_rel", "boxv", "pres_prev", "svir_prev",
               "fvir_prev"):
        if nm in state:
            state[nm] = state[nm].reshape(3, 3)
    for nm in ("x", "v", "cg_p"):
        if nm in state:
            state[nm] = state[nm].reshape(natoms, 3)

    # --- ekinstate (StateKineticEntry order, checkpoint.cpp:197) ---
    if flags_eks:
        kin_order = ["ekin_n", "ekinh", "dekindl", "mvcos", "ekinf",
                     "ekinh_old", "ekinscalef_nhc", "ekinscaleh_nhc",
                     "vscale_nhc", "ekin_total"]
        matrices = {"ekinh", "ekinf", "ekinh_old"}
        for i, nm in enumerate(kin_order):
            if not (flags_eks & (1 << i)):
                continue
            if nm in matrices:
                r.i32()              # leading matrix count (do_cpte_matrices)
            state["eks_" + nm] = r.record()

    # --- energy history (StateEnergyEntry order, :221) ---
    if flags_enh:
        def enh_bit(j):
            return bool(flags_enh & (1 << j))
        if enh_bit(0):
            r.record()               # energy_n
        if enh_bit(1):
            r.record()               # aver
        if enh_bit(2):
            r.record()               # sum
        if enh_bit(3):
            r.i64()                  # nsum (raw int64)
        if enh_bit(4):
            r.record()               # sum_sim
        if enh_bit(5):
            r.i64()                  # nsum_sim
        if enh_bit(6):
            r.i64()                  # nsteps
        if enh_bit(7):
            r.i64()                  # nsteps_sim
        n_dh = 0
        if enh_bit(8):
            n_dh = r.i32()           # delta_h_nn (raw int)
        if enh_bit(9):
            for _ in range(n_dh):
                r.record()           # each delta-H series
        if enh_bit(10):
            r.record()               # start_time
        if enh_bit(11):
            r.record()               # start_lambda

    for flag, what in ((flags_pullhist, "pull history"),
                       (flags_dfh, "expanded-ensemble df history"),
                       (nED, "essential dynamics"),
                       (eSwap, "swap state"),
                       (flags_awhh, "AWH history")):
        if flag:
            raise NotImplementedError(
                f"cpt: {what} section present in {path}; not supported")

    # --- output files ---
    nfiles = r.i32()
    files = []
    for _ in range(nfiles):
        fname = r.string()
        hi = r.i32()
        lo = r.u32()
        offset = (hi << 32) | lo if hi >= 0 else -1
        if fv >= V_FILE_CHECKSUM:
            r.i32()                  # checksum size
            # md5: 16 u_chars, each a 4-byte XDR unit (do_cpt_u_chars
            # :430 -> xdr_u_char)
            r._take(16 * 4)
        files.append((fname, offset))

    # MDModules + modular-simulator KV trees: only empty trees supported
    if fv >= V_MDMODULES:
        n_props = r.i32()
        if n_props != 0:
            raise NotImplementedError(
                f"cpt: MDModules checkpoint data present in {path}")
    if fv >= V_MODULAR_SIM:
        n_props = r.i32()
        if n_props != 0:
            raise NotImplementedError(
                f"cpt: modular-simulator checkpoint data in {path}")
    if r.i32() != CPT_MAGIC2:
        raise ValueError(f"{path}: bad checkpoint footer magic")

    return GmxCheckpoint(
        version_string=version_string, file_version=fv,
        double_prec=double_prec, natoms=natoms, ngtc=ngtc,
        nhchainlength=nhchainlength, nnhpres=nnhpres, nlambda=nlambda,
        integrator=integrator, simulation_part=simulation_part,
        step=step, t=t, flags_state=flags_state, state=state,
        output_files=files)
