"""Run driver — PyTorch counterpart of gromacs_fep_gpu_tpu/md/runner.py
(RunnerConfig, MdRunner: _foreign_factory, _flavor_pattern, the rebuild ->
nstlist-step chunk, _grow and roll-back on overflow) for the single-device
cluster paths (RunnerConfig.layout: v2u, super, cluster, v2 and the table
route), the dense oracle path (use_dense) and spatial domain decomposition
(RunnerConfig.mesh, dd_grid, dd_block).  With a lambda ladder
(all_lambda) the step loop records Delta H to every window each
fep.nstdhdl steps; expanded-ensemble and AWH moves are not ported.  With
pressure coupling the steps at step % nstpcouple == 0 take the virial
flavour of the force ('R', or 'S' with a sweep), and the box changes
inside a chunk: the baked periodic shifts are box-vector counts and the
PME influence function is rebuilt from the box at every call, so the
chunk's lists stay valid as they do under the coordinates' motion.

Each chunk rebuilds the pair lists (Hilbert sort, the layout's cluster
search, FEP list, the layout's pack) and then runs nstlist steps eagerly.
The list flags are read synchronously once per rebuild, before any step
uses the lists: on a capacity overflow the capacities grow by the JAX
contract (need = max(flag, cap) * 1.25 + 8, rounded up to 32 for the union
list and to 16 for the per-cluster list) and the chunk restarts from its
verified start state, so no step ever runs on an overflowed list.
Excluded pairs beyond rlist fail hard.

Domain decomposition (a mesh whose spatial axis has more than one domain):
the rebuild sorts atoms so that each domain owns a contiguous cluster range
(slab-major along x on a 1-D ring, the hierarchical equal-count sort on a
dd_grid), the non-bonded force runs per domain on its halo-extended plane
(K6 on the v2u layout, the table route's kernel on every other layout, as
the JAX runner demotes them) and the PME reciprocal part is sharded
(parallel/spatial.py).  A pair beyond the +-1 halo (a domain thinner than
the list cut-off) fails hard at the rebuild: no growth can cure it.  The
FEP list, the bonded terms, SETTLE, the update and the Delta H sweep stay
on the home device (the system's).  Pressure coupling under DD raises.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.types import CoulombType, MdParams, PcouplType, State, System
from ..ops import nb_cluster
from ..ops.cluster_nb import lj_table_mode, make_cluster_force_fn
from ..ops.forces import dense_energy, get_beta, make_dense_force_fn
from ..ops.foreign import make_foreign_delta_fn
from ..ops.nb_v2u import BU, prepare_v2u
from ..ops.pairlist import (build_cluster_pairlist, build_fep_pairlist,
                            check_exclusions, dd_geometry)
from .simulator import StepLog, make_step_fn, stack_logs
from .verletbuf import effective_rlist

FLAGS = ("fep_ovf", "s_ovf", "s_max", "n_ovf", "n_max", "excl_bad",
         "shift_bad", "t_ovf", "t_max", "halo_bad")


@dataclasses.dataclass
class RunnerConfig:
    """Capacities and the kernel layout.  layout and the JAX package's
    RunnerConfig(use_pallas, pallas_mode):
    - "v2u" (default): K1 on the union lists of 4-cluster blocks
      (use_pallas=True, pallas_mode="v2u", what bench.py runs);
    - "super": K7a on the union lists of 8-cluster superclusters
      (pallas_mode="super");
    - "cluster": K7b on the per-cluster lists (pallas_mode="cluster");
    - "v2": K7c on the per-cluster lists with baked shifts
      (pallas_mode="v2");
    - "table": the table route, the XLA cluster_nb_kernel's counterpart
      (use_pallas=False, the JAX RunnerConfig's default, and mdrun -fep
      cpu).
    The kernel layouts demote to "table" on a non-geometric LJ table or a
    vdW modifier other than potential-shift, as the JAX runner drops
    use_pallas (ops/cluster_nb.py effective_layout); LJ-PME raises.
    MdRunner.layout is the layout the force runs on; the config keeps
    the one asked for.  Pressure coupling runs on "v2u" and "table" (their kernels have a
    virial flavour) and raises on the K7 layouts."""
    layout: str = "v2u"
    super_nnbr: int = 384           # union-list capacity per i-block
    nnbr: int = 64                  # per-cluster list capacity
    fep_max_nbr: int = 256          # FEP partners per perturbed atom
    cell_size: Optional[float] = None   # sort-cell edge; default ~cluster
    tile_cap: Optional[int] = None  # two-level search tile capacity
    # bake build-time periodic shifts into the j stream; the runner turns
    # this off (in-loop minimum image) when a small box makes them
    # ambiguous, as the JAX runner does
    baked_shifts: bool = True
    seed: int = 0                   # v-rescale generator seed
    # dense O(N^2) oracle force (ops/forces.py) instead of the pair lists
    # and the K1 kernel: small systems only
    use_dense: bool = False
    # spatial domain decomposition: a parallel/mesh.py DeviceMesh whose
    # spatial axis holds the domains; dd_grid (P0, P1, P2) with prod ==
    # that axis' size, None = a 1-D ring of slabs along x; dd_block:
    # clusters per kernel block (each domain owns a multiple of it)
    mesh: Optional[object] = None
    dd_block: int = 8
    dd_grid: Optional[Tuple[int, ...]] = None


class MdRunner:
    """Owns the force function and the pair-list lifecycle."""

    def __init__(self, system: System, params: MdParams,
                 config: Optional[RunnerConfig] = None, all_lambda=None):
        """all_lambda: optional (L, 7) lambda ladder; when given, the step
        loop records Delta H to every window each fep.nstdhdl steps."""
        self.system = system
        self.params = params
        self.config = config or RunnerConfig()
        self.device = system.device
        self.all_lambda = None
        if all_lambda is not None:
            self.all_lambda = torch.as_tensor(
                np.asarray(all_lambda, np.float32), device=self.device)
        self.pert_idx = np.where(system.perturbed.cpu().numpy())[0]
        self.has_fep = self.pert_idx.size > 0
        self._dd_setup()
        self.recip_fn = self.recip_force_fn = self.recip_slope_fn = None
        if params.coulomb == CoulombType.PME:
            if params.pme_grid is None:
                raise ValueError("set params.pme_grid (use pme.pme_grid_size)")
            from ..ops.pme import make_pme_recip_fns
            (self.recip_fn, self.recip_force_fn,
             self.recip_slope_fn) = make_pme_recip_fns(system, params)
            if self.mesh is not None:
                from ..parallel.spatial import make_sharded_pme
                self.recip_force_fn = make_sharded_pme(system, params,
                                                       self.mesh)
        if self.config.use_dense:
            dense = make_dense_force_fn(system, params, self.recip_fn)
            self._force_fn = (lambda x, box, lam, nl, fl, prep=None,
                              **_flavor_kwargs: dense(x, box, lam))
            self.layout = None
        elif self.mesh is not None:
            self._dd_override = self._make_dd_override()
            self._force_fn = make_cluster_force_fn(
                system, params, has_fep=self.has_fep,
                pme_recip_force_fn=self.recip_force_fn,
                layout=self._dd_override.layout,
                nb_kernel_override=self._dd_override)
            self.layout = self._dd_override.layout
        else:
            self._force_fn = make_cluster_force_fn(
                system, params, has_fep=self.has_fep,
                pme_recip_force_fn=self.recip_force_fn,
                layout=self.config.layout)
            # the layout the force runs on, after the demotion
            self.layout = self._force_fn.layout
        self._foreign, self._n_foreign = self._foreign_factory()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.config.seed)
        self._rlist = None
        self.last_flags = None      # flags of the newest accepted rebuild
        self.n_regrow = 0           # chunks restarted after an overflow

    def _dd_setup(self):
        """Domain decomposition from config.mesh (JAX runner.py:143-163):
        self.mesh (None without DD), the domain grid and the DD sort."""
        cfg = self.config
        self.mesh, self._dd_grid, self._dd_sort = None, None, None
        if cfg.mesh is None or cfg.use_dense:
            return
        from ..parallel.mesh import SPATIAL_AXIS
        nsh = cfg.mesh.shape[SPATIAL_AXIS]
        if nsh <= 1:
            return
        kinds = {d.type for d in cfg.mesh.spatial_devices}
        if kinds != {self.device.type}:
            raise ValueError(
                f"the mesh's domains lie on {sorted(kinds)} but the system "
                f"on {self.device.type}: domains run on the system's kind "
                "of device")
        if self.params.pcoupl != PcouplType.NO:
            raise NotImplementedError(
                "pressure coupling under domain decomposition is not ported "
                "(the JAX runner keeps its decomposed virial off under DD)")
        self.mesh = cfg.mesh
        self._dd_grid = nsh
        if cfg.dd_grid is not None:
            grid = tuple(cfg.dd_grid) + (1,) * (3 - len(cfg.dd_grid))
            if int(np.prod(grid)) != nsh:
                raise ValueError(f"dd_grid {grid} does not cover the "
                                 f"{nsh}-device spatial mesh axis")
            ps, _ = dd_geometry(self.system.n_atoms, grid, cfg.dd_block)
            self._dd_grid = grid
            self._dd_sort = (grid, ps)

    def _make_dd_override(self):
        """K6 on the v2u layout; every other layout (and a v2u layout that
        demotes: a non-geometric LJ table or another vdW modifier) runs the
        table route under DD, as the JAX runner drops use_pallas."""
        from ..parallel.spatial import (make_dd_nb_override,
                                        make_dd_v2u_override)
        from ..ops.cluster_nb import effective_layout
        layout = effective_layout(self.system.nbfp.cpu().numpy(),
                                  self.params, self.config.layout)
        make = make_dd_v2u_override if layout == "v2u" \
            else make_dd_nb_override
        return make(self.system, self.params, self.mesh,
                    get_beta(self.params), block=self.config.dd_block,
                    grid=self._dd_grid)

    def _foreign_factory(self):
        """(factory, n_foreign): factory(feplist) -> delta(x, box, lam), the
        (L,) Delta H sweep on one rebuild's FEP list.  Dense: differences
        of the whole potential, one dense_energy per window (the oracle:
        it shares nothing with the batched sweep).  Cluster route:
        make_foreign_delta_fn over the lambda-dependent terms only."""
        if self.all_lambda is None:
            return None, 0
        n_foreign = int(self.all_lambda.shape[0])
        if self.config.use_dense:
            beta = get_beta(self.params)

            def factory(feplist):
                def delta(x, box, lam):
                    def e_at(lm):
                        return dense_energy(x, box, lm, self.system,
                                            self.params, beta,
                                            self.recip_fn).epot
                    with torch.no_grad():
                        return torch.stack(
                            [e_at(lm) for lm in self.all_lambda.to(x.dtype)]
                        ) - e_at(lam)
                return delta
        else:
            delta_core = make_foreign_delta_fn(
                self.system, self.params, self.all_lambda,
                self.recip_slope_fn)

            def factory(feplist):
                return lambda x, box, lam: delta_core(x, box, lam, feplist)
        return factory, n_foreign

    def _flavor_pattern(self, start_step: int, seg_len: int) -> str:
        """Per-offset force flavour: 'F' force only, 'E' energies, 'D'
        energies and the foreign-lambda sweep, 'R' energies and the virial
        (pressure steps of the cluster route), 'S' 'R' and the sweep, 'f'
        MTS off-step (host-computable: every trigger is step % N == 0)."""
        p = self.params
        noener_active = not self.config.use_dense and p.nstcalcenergy > 1
        # the virial flavour: K1 and the table route (JAX: the XLA kernel
        # and the v2u Pallas kernel, runner.py:307-312)
        vir_active = (p.pcoupl != PcouplType.NO
                      and self.layout in ("v2u", "table"))
        out = []
        for o in range(seg_len):
            s = start_step + o
            foreign = (self.all_lambda is not None
                       and (s % p.fep.nstdhdl) == 0)
            if noener_active:
                ener = (s % p.nstcalcenergy) == 0 or foreign
                if p.fep.enabled:
                    ener = ener or (s % p.fep.nstdhdl) == 0
            else:
                ener = True
            vir = vir_active and (s % p.nstpcouple) == 0
            fl = "R" if vir else ("E" if ener else "F")
            if foreign:
                fl = {"E": "D", "R": "S"}[fl]
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
        if cfg.use_dense:
            return None, None, None, dict.fromkeys(FLAGS, 0)
        layout = self.layout
        per_cluster = layout in ("cluster", "v2", "table")
        nlist = build_cluster_pairlist(
            state.x, state.box, self.system, self._rlist,
            nnbr=cfg.nnbr if per_cluster else 0,
            cell_size=cfg.cell_size,
            super_nnbr=None if per_cluster else cfg.super_nnbr,
            compute_shifts=(layout == "v2"
                            or (layout == "v2u" and cfg.baked_shifts)),
            super_block=8 if layout == "super" else BU,
            tile_cap=cfg.tile_cap,
            # DD: slab-major along x on a 1-D ring, else the N-D sort
            slab_axis=(0 if self.mesh is not None and self._dd_sort is None
                       else None),
            dd_sort=self._dd_sort)
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
        nbfp = self.system.nbfp
        halo_bad = zero
        if self.mesh is not None:
            from ..parallel.spatial import halo_violations
            halo_bad = halo_violations(nlist, self._dd_grid, cfg.dd_block)
            prep = self._dd_override.prepare(
                nlist, prepare_v2u(nlist, nbfp) if layout == "v2u" else None)
        elif layout == "v2u":
            prep = prepare_v2u(nlist, nbfp)
        elif layout == "table":
            prep = nb_cluster.prepare_table(
                nlist, nbfp, lj_table_mode(nbfp.cpu().numpy()))
        else:
            prep = nb_cluster.PREPARE[layout](nlist, nbfp)

        def flag(t):
            return zero if t is None else t
        flags = torch.stack([
            fep_ovf, flag(nlist.super_overflow), flag(nlist.super_max_count),
            flag(nlist.n_overflow), flag(nlist.max_count), excl_bad,
            flag(nlist.shift_overflow), flag(nlist.tile_overflow),
            flag(nlist.tile_max), halo_bad.to(zero.device)]).to(torch.int64)
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
        if fl["n_ovf"] > 0:
            need = int(max(fl["n_max"], cfg.nnbr) * 1.25 + 8)
            cfg.nnbr = (need + 15) // 16 * 16
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
            if self.config.use_dense:
                raise ValueError("the dense force does not split off the "
                                 "reciprocal force: no mts with use_dense")
            checks = [("nstcalcenergy", p.nstcalcenergy)]
            if p.fep.enabled or self.all_lambda is not None:
                checks.append(("nstdhdl", p.fep.nstdhdl))
            if p.pcoupl != PcouplType.NO:
                checks.append(("nstpcouple", p.nstpcouple))
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
            if flavor in ("R", "S"):
                return self._force_fn(x, box, lam, nlist, feplist, prep,
                                      need_energy=True, need_virial=True,
                                      recip_scale=rs)
            return self._force_fn(x, box, lam, nlist, feplist, prep,
                                  need_energy=flavor in ("E", "D"),
                                  recip_scale=rs)

        epot_fn = None
        if self.config.use_dense:
            beta = get_beta(self.params)

            def epot_fn(x, box, lam):
                return dense_energy(x, box, lam, self.system, self.params,
                                    beta, self.recip_fn).epot

        return make_step_fn(
            self.system, self.params, bound, self.generator,
            foreign_delta_fn=(self._foreign(feplist) if self._foreign
                              else None),
            n_foreign=self._n_foreign, energy_epot_fn=epot_fn)

    def lists(self, state: State):
        """(nlist, feplist, prep, flags) of a rebuild at `state` that no
        list overflows: on an overflow the capacities grow (_grow) and on
        a box too small for build-time shifts the v2u layout takes the
        in-loop minimum image, each time rebuilding (counted in
        n_regrow).  Excluded pairs beyond rlist fail hard."""
        cfg = self.config
        while True:
            nlist, feplist, prep, fl = self.rebuild(state)
            if fl["excl_bad"] > 0:
                raise RuntimeError(
                    f"{fl['excl_bad']} excluded atom pair(s) beyond the "
                    f"pair-list cutoff ({self._rlist:.3f} nm): their "
                    "RF/Ewald exclusion corrections would be lost "
                    "(reference: nbnxm/exclusionchecker.cpp fails hard)")
            if fl["halo_bad"] > 0:
                raise RuntimeError(
                    f"{fl['halo_bad']} pair(s) reach beyond the "
                    "ring-halo neighbourhood: the spatial slabs are "
                    "thinner than the pair-list cutoff for this mesh. "
                    "Use fewer spatial shards or a larger box "
                    "(reference behavior: domdec cell-size-vs-cutoff "
                    "fatal error, domdec.cpp)")
            if fl["shift_bad"] > 0:
                if self.layout == "v2":
                    raise RuntimeError(
                        "cluster extents too large relative to the box for "
                        "the v2 kernel's build-time periodic shifts "
                        "(gas-density system or tiny box); rerun with "
                        "RunnerConfig(layout='cluster') or use_dense")
                # cluster extents too large relative to the box for
                # build-time shifts: switch to the in-loop minimum image
                cfg.baked_shifts = False
                self.n_regrow += 1
                continue
            if self._grow(fl):
                self.n_regrow += 1
                continue
            return nlist, feplist, prep, fl

    def run(self, state: State, nsteps: int
            ) -> Tuple[State, List[StepLog]]:
        """Run nsteps; returns (final state, per-chunk stacked StepLogs).
        Each chunk rebuilds its lists at its verified start state (lists),
        so a roll-back on overflow never runs a step on an overflowed
        list."""
        self._check_run(state)
        self._set_geometry(state)
        nst = max(1, min(self.params.nstlist, nsteps))
        logs, done = [], 0
        while done < nsteps:
            seg_len = min(nst, nsteps - done)
            flavors = self._flavor_pattern(state.step, seg_len)
            nlist, feplist, prep, fl = self.lists(state)
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
