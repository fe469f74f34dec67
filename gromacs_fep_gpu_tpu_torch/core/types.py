"""Core data model: System, State, MdParams — PyTorch counterpart of
gromacs_fep_gpu_tpu/core/types.py (MdParams, FepParams, the enums, System,
State, InteractionList, SettleGroups, LincsConstraints, EnergyTerms,
make_state).

The flax pytrees become plain dataclasses of tensors.  Only the fields the
port's paths read are kept; settings outside them that MdParams does carry
(the md-vv and bd integrators, thermostats other than v-rescale, the
MTTK barostat, anisotropic and surface-tension pressure coupling, slow
growth) raise NotImplementedError where they are consumed.

`from_numpy` is the parameter bridge: it builds the port's System and State
from dicts of numpy arrays (the tests fill them from the JAX pytrees with
np.asarray), so both sides compute on identical inputs.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import numpy as np
import torch


class CoulombType(enum.Enum):
    CUTOFF = "cutoff"
    REACTION_FIELD = "reaction-field"
    PME = "pme"


class VdwModifier(enum.Enum):
    NONE = "none"
    POTENTIAL_SHIFT = "potential-shift"
    POTENTIAL_SWITCH = "potential-switch"
    FORCE_SWITCH = "force-switch"


class SoftcoreType(enum.Enum):
    BEUTLER = "beutler"
    GAPSYS = "gapsys"


class IntegratorType(enum.Enum):
    MD = "md"            # leapfrog
    MD_VV = "md-vv"
    SD = "sd"            # leapfrog Langevin (md/integrators.py)
    BD = "bd"


class TcouplType(enum.Enum):
    NO = "no"
    BERENDSEN = "berendsen"
    V_RESCALE = "v-rescale"
    NOSE_HOOVER = "nose-hoover"
    ANDERSEN_MASSIVE = "andersen-massive"


class PcouplType(enum.Enum):
    NO = "no"
    MTTK = "mttk"
    BERENDSEN = "berendsen"
    C_RESCALE = "c-rescale"
    PARRINELLO_RAHMAN = "parrinello-rahman"


class FepCoupling(enum.IntEnum):
    """Per-component lambda channels
    (reference: mdtypes/md_enums.h FreeEnergyPerturbationCouplingType)."""
    FEP = 0
    MASS = 1
    COUL = 2
    VDW = 3
    BONDED = 4
    RESTRAINT = 5
    TEMPERATURE = 6
    COUNT = 7


@dataclasses.dataclass(frozen=True)
class FepParams:
    """Static FEP settings (reference: t_lambda, inputrec.h)."""
    enabled: bool = False
    init_lambda_state: int = -1        # index into all_lambda (-1 = unset)
    init_lambda: float = -1.0          # scalar lambda (-1 = unset)
    delta_lambda: float = 0.0
    sc_alpha: float = 0.0
    sc_power: int = 1
    sc_sigma: float = 0.3
    sc_sigma_min: float = 0.3
    sc_coul: bool = False
    softcore: SoftcoreType = SoftcoreType.BEUTLER
    nstdhdl: int = 100
    calc_foreign: bool = True          # compute all foreign-lambda energies
    calc_lambda_neighbors: int = -1    # -1 = all, n = +-n neighbors


@dataclasses.dataclass(frozen=True)
class MdParams:
    """Static run parameters — the t_inputrec analogue (the subset of the
    JAX MdParams that the ported path reads; same names and defaults)."""
    dt: float = 0.002
    nsteps: int = 0
    integrator: IntegratorType = IntegratorType.MD
    rcoulomb: float = 1.0
    rvdw: float = 1.0
    rlist: float = 1.05
    nstlist: int = 10
    coulomb: CoulombType = CoulombType.REACTION_FIELD
    vdw_modifier: VdwModifier = VdwModifier.POTENTIAL_SHIFT
    vdw_type: str = "cut-off"
    epsilon_r: float = 1.0
    epsilon_rf: float = 0.0            # 0 => infinity (conducting RF)
    rvdw_switch: float = 0.9
    ewald_rtol: float = 1e-5
    fourier_spacing: float = 0.12
    pme_order: int = 4
    pme_grid: Optional[Tuple[int, int, int]] = None
    dispcorr: bool = False
    tcoupl: TcouplType = TcouplType.NO
    ref_t: float = 300.0
    tau_t: float = 1.0
    nsttcouple: int = 10
    pcoupl: PcouplType = PcouplType.NO
    # isotropic | semiisotropic (x and y jointly, z on its own);
    # anisotropic and surface-tension raise where the step consumes them
    pcoupltype: str = "isotropic"
    ref_p: float = 1.0                 # bar
    ref_p_z: Optional[float] = None    # semiisotropic z target; None: ref_p
    tau_p: float = 5.0                 # ps
    compressibility: float = 4.5e-5    # bar^-1
    # semiisotropic z compressibility; None: compressibility
    compressibility_z: Optional[float] = None
    nstpcouple: int = 10
    ld_seed: int = 1993                # seeds the thermostat's generator
    nstcomm: int = 100
    # trajectory output (trr / xtc frames every N steps; the port writes
    # neither yet, so the mdp reader raises on N > 0)
    nstxout: int = 0
    nstxout_compressed: int = 0
    nstcalcenergy: int = 1
    nstlog: int = 1000                 # md.log energy-block interval
    # LINCS expansion order and length-correction rounds (mdp lincs-order,
    # lincs-iter)
    lincs_order: int = 4
    lincs_iter: int = 2
    mts: bool = False
    mts_factor: int = 2
    mts_forces: str = "longrange-nonbonded"
    # distance-restraint force constant (mdp disre-fc; reference:
    # listed_forces/disre.cpp)
    disre_fc: float = 1000.0
    fep: FepParams = FepParams()

    def replace(self, **kw) -> "MdParams":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Interaction lists and the System
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InteractionList:
    """Padded list of k-body interactions of one function type:
    atoms (n, k) int64, params_a/params_b (n, p) f32, mask (n,) f32."""
    atoms: torch.Tensor
    params_a: torch.Tensor
    params_b: torch.Tensor
    mask: torch.Tensor

    @property
    def n(self) -> int:
        return self.atoms.shape[0]


@dataclasses.dataclass
class SettleGroups:
    """Rigid 3-site water groups: atoms (n, 3) (O, H1, H2); d_oh, d_hh,
    mask (n,)."""
    atoms: torch.Tensor
    d_oh: torch.Tensor
    d_hh: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass
class LincsConstraints:
    """Pairwise holonomic constraints solved with LINCS: atoms (n, 2),
    length_a, length_b (n,) (FEP-perturbed lengths), mask (n,)."""
    atoms: torch.Tensor
    length_a: torch.Tensor
    length_b: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def empty(device="cpu") -> "LincsConstraints":
        z = torch.zeros((0,), device=device)
        return LincsConstraints(
            atoms=torch.zeros((0, 2), dtype=torch.int64, device=device),
            length_a=z, length_b=z, mask=z)


@dataclasses.dataclass
class System:
    """Static topology + parameters on one device.  exclusions: (N, K)
    partner ids padded with -1; bonded: name -> InteractionList; pairs14:
    1-4 pairs, k=2, p=3 (qq with epsfac and fudgeQQ applied, c6, c12), None
    when the topology has none; lincs: the constraints other than the
    SETTLE waters."""
    charge_a: torch.Tensor
    charge_b: torch.Tensor
    type_a: torch.Tensor
    type_b: torch.Tensor
    mass_a: torch.Tensor
    mass_b: torch.Tensor
    perturbed: torch.Tensor        # (N,) bool
    nbfp: torch.Tensor             # (T, T, 2) c6, c12
    exclusions: torch.Tensor       # (N, K) int64, -1 padded
    bonded: Dict[str, InteractionList]
    settle: SettleGroups
    lincs: LincsConstraints
    n_atoms: int = 0
    pairs14: Optional[InteractionList] = None

    @property
    def device(self) -> torch.device:
        return self.charge_a.device


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CouplingState:
    """v-rescale bookkeeping: therm_integral and ekinh_prev (-1 = not yet
    initialized; first step uses the current KE twice); boxv: the (3, 3)
    Parrinello-Rahman box velocity (nm/ps, diagonal in the port), zero at
    the start."""
    therm_integral: torch.Tensor
    ekinh_prev: torch.Tensor
    boxv: torch.Tensor


@dataclasses.dataclass
class State:
    """Dynamic state.  `step` is a host integer: every trigger of the main
    path is step % N == 0 with a static N, so the host always knows it and
    never reads it back from the device."""
    x: torch.Tensor
    v: torch.Tensor
    box: torch.Tensor
    lam: torch.Tensor              # (7,)
    coupling: CouplingState
    step: int = 0
    fep_state: int = 0             # index of the current lambda window

    @property
    def n_atoms(self) -> int:
        return self.x.shape[0]

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


def make_state(x, v, box, lam=None, device="cuda", fep_state=0) -> State:
    """State from array-likes (float32 on `device`)."""
    dev = torch.device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    n = np.asarray(x).shape[0]
    if lam is None:
        lam = np.zeros((int(FepCoupling.COUNT),), np.float32)
    return State(
        x=t(x), v=t(v) if v is not None else torch.zeros((n, 3), device=dev),
        box=t(box), lam=t(lam),
        coupling=CouplingState(
            therm_integral=torch.zeros((), device=dev),
            ekinh_prev=torch.full((), -1.0, device=dev),
            boxv=torch.zeros((3, 3), device=dev)),
        step=0, fep_state=int(fep_state))


# ---------------------------------------------------------------------------
# Energy bookkeeping
# ---------------------------------------------------------------------------

_ENERGY_FIELDS = ("lj", "coulomb", "lj_recip", "coul_recip", "bonds",
                  "angles", "dihedrals", "impropers", "lj14", "coul14",
                  "restraints", "dispcorr")


@dataclasses.dataclass
class EnergyTerms:
    """Potential-energy decomposition + dV/dlambda per FepCoupling channel
    (reference: mdtypes/enerdata.h)."""
    lj: torch.Tensor
    coulomb: torch.Tensor
    lj_recip: torch.Tensor
    coul_recip: torch.Tensor
    bonds: torch.Tensor
    angles: torch.Tensor
    dihedrals: torch.Tensor
    impropers: torch.Tensor
    lj14: torch.Tensor
    coul14: torch.Tensor
    restraints: torch.Tensor
    dispcorr: torch.Tensor
    dvdl: torch.Tensor
    # (3,) diagonal potential virial Xi_aa of the force pass; zeros unless
    # the force function ran with need_virial
    vir_diag: Optional[torch.Tensor] = None

    @property
    def epot(self) -> torch.Tensor:
        return sum(getattr(self, k) for k in _ENERGY_FIELDS)

    @staticmethod
    def zeros(device, dtype=torch.float32) -> "EnergyTerms":
        z = torch.zeros((), device=device, dtype=dtype)
        return EnergyTerms(**{k: z for k in _ENERGY_FIELDS},
                           dvdl=torch.zeros((int(FepCoupling.COUNT),),
                                            device=device, dtype=dtype),
                           vir_diag=torch.zeros((3,), device=device,
                                                dtype=dtype))

    def replace(self, **kw) -> "EnergyTerms":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Parameter bridge
# ---------------------------------------------------------------------------

def from_numpy(system_arrays: dict, state_arrays: dict, device
               ) -> Tuple[System, State]:
    """Build (System, State) from numpy arrays.

    system_arrays keys: charge_a, charge_b, type_a, type_b, mass_a, mass_b,
    perturbed, nbfp, exclusions, settle_atoms, settle_d_oh, settle_d_hh,
    settle_mask, optionally lincs_atoms, lincs_length_a, lincs_length_b,
    lincs_mask (absent = no LINCS rows), and for each bonded term `name`:
    bonded_<name>_atoms,
    bonded_<name>_params_a, bonded_<name>_params_b, bonded_<name>_mask;
    optionally pairs14_atoms, pairs14_params_a, pairs14_params_b,
    pairs14_mask.  state_arrays keys: x, v, box, lam and optionally
    fep_state."""
    dev = torch.device(device)

    def f(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def i(a):
        return torch.tensor(np.asarray(a, np.int64), device=dev)

    s = system_arrays

    def ilist(prefix):
        return InteractionList(
            atoms=i(s[f"{prefix}_atoms"]),
            params_a=f(s[f"{prefix}_params_a"]),
            params_b=f(s[f"{prefix}_params_b"]), mask=f(s[f"{prefix}_mask"]))

    bonded = {}
    for key in s:
        if key.startswith("bonded_") and key.endswith("_atoms"):
            name = key[len("bonded_"):-len("_atoms")]
            bonded[name] = ilist(f"bonded_{name}")
    lincs = LincsConstraints.empty(dev)
    if "lincs_atoms" in s:
        lincs = LincsConstraints(
            atoms=i(np.asarray(s["lincs_atoms"]).reshape(-1, 2)),
            length_a=f(s["lincs_length_a"]),
            length_b=f(s["lincs_length_b"]), mask=f(s["lincs_mask"]))
    pairs14 = None
    if "pairs14_atoms" in s and np.asarray(s["pairs14_atoms"]).shape[0] > 0:
        pairs14 = ilist("pairs14")
    system = System(
        charge_a=f(s["charge_a"]), charge_b=f(s["charge_b"]),
        type_a=i(s["type_a"]), type_b=i(s["type_b"]),
        mass_a=f(s["mass_a"]), mass_b=f(s["mass_b"]),
        perturbed=torch.tensor(np.asarray(s["perturbed"], bool),
                               device=dev),
        nbfp=f(s["nbfp"]), exclusions=i(s["exclusions"]), bonded=bonded,
        settle=SettleGroups(atoms=i(s["settle_atoms"]),
                            d_oh=f(s["settle_d_oh"]),
                            d_hh=f(s["settle_d_hh"]),
                            mask=f(s["settle_mask"])),
        lincs=lincs, n_atoms=int(np.asarray(s["charge_a"]).shape[0]),
        pairs14=pairs14)
    st = state_arrays
    state = make_state(st["x"], st["v"], st["box"], st.get("lam"),
                       device=dev, fep_state=int(st.get("fep_state", 0)))
    return system, state


def to_numpy(system: System) -> dict:
    """Inverse of from_numpy's system half (host numpy arrays)."""
    def n(t):
        return t.detach().cpu().numpy()
    out = {k: n(getattr(system, k)) for k in (
        "charge_a", "charge_b", "type_a", "type_b", "mass_a", "mass_b",
        "perturbed", "nbfp", "exclusions")}
    out.update(settle_atoms=n(system.settle.atoms),
               settle_d_oh=n(system.settle.d_oh),
               settle_d_hh=n(system.settle.d_hh),
               settle_mask=n(system.settle.mask),
               lincs_atoms=n(system.lincs.atoms),
               lincs_length_a=n(system.lincs.length_a),
               lincs_length_b=n(system.lincs.length_b),
               lincs_mask=n(system.lincs.mask))
    lists = {f"bonded_{name}": il for name, il in system.bonded.items()}
    if system.pairs14 is not None:
        lists["pairs14"] = system.pairs14
    for prefix, il in lists.items():
        out[f"{prefix}_atoms"] = n(il.atoms)
        out[f"{prefix}_params_a"] = n(il.params_a)
        out[f"{prefix}_params_b"] = n(il.params_b)
        out[f"{prefix}_mask"] = n(il.mask)
    return out
