"""Run driver — PyTorch counterpart of gromacs_fep_gpu_tpu/md/runner.py
(RunnerConfig, MdRunner: _flavor_pattern, the rebuild -> nstlist-step
chunk, _grow and roll-back on overflow) for the single-device v2u path.

Each chunk rebuilds the pair lists (Hilbert sort, union cluster search
with baked shifts, FEP list, v2u pack) and then runs nstlist steps
eagerly.  The list flags are read synchronously once per rebuild, before
any step uses the lists: on a capacity overflow the capacities grow by the
JAX contract (need = max(flag, cap) * 1.25 + 8) and the chunk restarts
from its verified start state, so no step ever runs on an overflowed
list.  Excluded pairs beyond rlist fail hard.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.types import CoulombType, MdParams, State, System
from ..ops.cluster_nb import make_cluster_force_fn
from ..ops.nb_v2u import BU, prepare_v2u
from ..ops.pairlist import (build_cluster_pairlist, build_fep_pairlist,
                            check_exclusions)
from .simulator import StepLog, make_step_fn, stack_logs
from .verletbuf import effective_rlist

FLAGS = ("fep_ovf", "s_ovf", "s_max", "excl_bad", "shift_bad", "t_ovf",
         "t_max")


@dataclasses.dataclass
class RunnerConfig:
    super_nnbr: int = 384           # union-list capacity per i-block
    fep_max_nbr: int = 256          # FEP partners per perturbed atom
    cell_size: Optional[float] = None   # sort-cell edge; default ~cluster
    tile_cap: Optional[int] = None  # two-level search tile capacity
    # bake build-time periodic shifts into the j stream; the runner turns
    # this off (in-loop minimum image) when a small box makes them
    # ambiguous, as the JAX runner does
    baked_shifts: bool = True
    seed: int = 0                   # v-rescale generator seed


class MdRunner:
    """Owns the force function and the pair-list lifecycle."""

    def __init__(self, system: System, params: MdParams,
                 config: Optional[RunnerConfig] = None):
        self.system = system
        self.params = params
        self.config = config or RunnerConfig()
        self.device = system.device
        self.pert_idx = np.where(system.perturbed.cpu().numpy())[0]
        self.has_fep = self.pert_idx.size > 0
        self.recip_fn = self.recip_force_fn = None
        if params.coulomb == CoulombType.PME:
            if params.pme_grid is None:
                raise ValueError("set params.pme_grid (use pme.pme_grid_size)")
            from ..ops.pme import make_pme_recip_pair
            self.recip_fn, self.recip_force_fn = make_pme_recip_pair(
                system, params)
        self._force_fn = make_cluster_force_fn(
            system, params, has_fep=self.has_fep,
            pme_recip_force_fn=self.recip_force_fn)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.config.seed)
        self._rlist = None
        self.last_flags = None      # flags of the newest accepted rebuild
        self.n_regrow = 0           # chunks restarted after an overflow

    def _flavor_pattern(self, start_step: int, seg_len: int) -> str:
        """Per-offset force flavour: 'F' force only, 'E' energies, 'f' MTS
        off-step (host-computable: every trigger is step % N == 0)."""
        p = self.params
        out = []
        for o in range(seg_len):
            s = start_step + o
            if p.nstcalcenergy > 1:
                ener = (s % p.nstcalcenergy) == 0
                if p.fep.enabled:
                    ener = ener or (s % p.fep.nstdhdl) == 0
            else:
                ener = True
            fl = "E" if ener else "F"
            if p.mts and (s % p.mts_factor) != 0:
                if fl != "F":
                    raise ValueError(
                        f"step {s}: energy step not aligned with "
                        f"mts-level2-factor {p.mts_factor}")
                fl = "f"
            out.append(fl)
        return "".join(out)

    def _set_geometry(self, state: State):
        """Sort-cell edge and buffered rlist, fixed at the first call."""
        cfg = self.config
        vol = float(np.prod(np.diag(state.box.cpu().numpy())))
        if cfg.cell_size is None:
            n = max(self.system.n_atoms, 1)
            cfg.cell_size = max((8.0 * vol / n) ** (1.0 / 3.0), 0.15)
        if self._rlist is None:
            self._rlist = effective_rlist(self.params, system=self.system,
                                          volume=vol)

    def rebuild(self, state: State):
        """(nlist, feplist, prep, flags) of one pair-list rebuild; the
        flags are read back to the host."""
        self._set_geometry(state)
        cfg = self.config
        nlist = build_cluster_pairlist(
            state.x, state.box, self.system, self._rlist,
            cell_size=cfg.cell_size, super_nnbr=cfg.super_nnbr,
            compute_shifts=cfg.baked_shifts, super_block=BU,
            tile_cap=cfg.tile_cap)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        feplist, fep_ovf = None, zero
        if self.has_fep:
            feplist = build_fep_pairlist(state.x, state.box, self.system,
                                         self._rlist, self.pert_idx,
                                         max_nbr=cfg.fep_max_nbr)
            fep_ovf = feplist.n_overflow
        excl_bad = zero
        if self.params.coulomb in (CoulombType.PME,
                                   CoulombType.REACTION_FIELD):
            excl_bad = check_exclusions(state.x, state.box, self.system,
                                        self._rlist, skip_perturbed=True)
        prep = prepare_v2u(nlist, self.system.nbfp)
        flags = torch.stack([
            fep_ovf, nlist.super_overflow, nlist.super_max_count, excl_bad,
            (nlist.shift_overflow if nlist.shift_overflow is not None
             else zero),
            nlist.tile_overflow if nlist.tile_overflow is not None else zero,
            nlist.tile_max if nlist.tile_max is not None else zero,
        ]).to(torch.int64)
        return nlist, feplist, prep, dict(zip(FLAGS, flags.cpu().tolist()))

    def _grow(self, fl: dict) -> bool:
        """Grow the overflowed capacities; True if any did."""
        cfg = self.config
        grown = False
        if fl["fep_ovf"] > 0:
            cfg.fep_max_nbr = int(cfg.fep_max_nbr * 1.5 + 8)
            grown = True
        if fl["s_ovf"] > 0:
            need = int(max(fl["s_max"], cfg.super_nnbr) * 1.25 + 8)
            cfg.super_nnbr = (need + 31) // 32 * 32
            grown = True
        if fl["t_ovf"] > 0:
            cfg.tile_cap = int(max(fl["t_max"], cfg.tile_cap or 0)
                               * 1.25) + 8
            grown = True
        return grown

    def _check_run(self, state: State):
        p = self.params
        if p.mts:
            m = p.mts_factor
            if p.mts_forces != "longrange-nonbonded":
                raise ValueError("only mts-level2-forces = "
                                 "longrange-nonbonded is supported")
            if self.recip_force_fn is None:
                raise ValueError("mts requires PME")
            checks = [("nstcalcenergy", p.nstcalcenergy)]
            if p.fep.enabled:
                checks.append(("nstdhdl", p.fep.nstdhdl))
            for nm, n in checks:
                if n <= 1 or n % m != 0:
                    raise ValueError(
                        f"mts-level2-factor {m} requires {nm} (= {n}) to "
                        "be a multiple of it (reference: readir.cpp)")
        b = state.box.cpu().numpy()
        if np.abs(b - np.diag(np.diag(b))).max() > 1e-6:
            raise NotImplementedError("triclinic boxes are not ported yet")

    def step_fn(self, nlist, feplist, prep):
        """step(state, flavor) on one rebuild's lists (make_step_fn with
        the force bound to them; MTS scales the reciprocal force on
        on-steps and skips it on off-steps)."""
        rs = float(self.params.mts_factor) if self.params.mts else 1.0

        def bound(x, box, lam, flavor):
            if flavor == "f":
                return self._force_fn(x, box, lam, nlist, feplist, prep,
                                      need_energy=False, skip_recip=True)
            return self._force_fn(x, box, lam, nlist, feplist, prep,
                                  need_energy=flavor == "E", recip_scale=rs)

        return make_step_fn(self.system, self.params, bound, self.generator)

    def run(self, state: State, nsteps: int
            ) -> Tuple[State, List[StepLog]]:
        """Run nsteps; returns (final state, per-chunk stacked StepLogs)."""
        self._check_run(state)
        cfg = self.config
        self._set_geometry(state)
        nst = max(1, min(self.params.nstlist, nsteps))
        logs, done = [], 0
        while done < nsteps:
            seg_len = min(nst, nsteps - done)
            flavors = self._flavor_pattern(state.step, seg_len)
            nlist, feplist, prep, fl = self.rebuild(state)
            if fl["excl_bad"] > 0:
                raise RuntimeError(
                    f"{fl['excl_bad']} excluded atom pair(s) beyond the "
                    f"pair-list cutoff ({self._rlist:.3f} nm): their "
                    "RF/Ewald exclusion corrections would be lost "
                    "(reference: nbnxm/exclusionchecker.cpp fails hard)")
            if fl["shift_bad"] > 0:
                # cluster extents too large relative to the box for
                # build-time shifts: switch to the in-loop minimum image
                # and restart the chunk
                cfg.baked_shifts = False
                self.n_regrow += 1
                continue
            if self._grow(fl):
                # roll back: the chunk restarts from its verified start
                self.n_regrow += 1
                continue
            self.last_flags = fl
            step = self.step_fn(nlist, feplist, prep)
            chunk_logs = []
            for flavor in flavors:
                state, lg = step(state, flavor)
                chunk_logs.append(lg)
            logs.append(stack_logs(chunk_logs))
            done += seg_len
        return state, logs


def concat_logs(logs: List[StepLog]) -> StepLog:
    return StepLog(**{k.name: torch.cat([getattr(lg, k.name) for lg in logs])
                      for k in dataclasses.fields(StepLog)})
