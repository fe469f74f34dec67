#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gromacs_fep_gpu_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:

1. print the card's name and power limit; build every CUDA kernel from
   gromacs_fep_gpu_tpu_torch/csrc with nvcc and print the build time;
2. small reference: the port's MdRunner on the GPU (kernels) against the
   same run on the CPU (plain versions) for a 650-atom box, with a
   5-window lambda ladder: positions, energies, dV/dlambda and the
   foreign-lambda Delta H; then the GPU's Delta H on its final frame
   against the dense O(N^2) oracle in float64;
3. main path, equilibration: the 12,290-atom solvation-FEP system
   (n_side 16, ligand at lambda_coul = lambda_vdw = 0.5), dt 0.5 fs,
   tau_t 0.1 ps, no MTS, 2000 steps (1 ps), through MdRunner.run;
4. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (equilibrated state, production pair list), with
   its time, its plain version's time and its bound;
5. main path, production: >= 400 steps at dt 2 fs with MTS2 through
   MdRunner.run; the launch counters must rise by what the flavour pattern
   predicts, energies and dV/dlambda must be finite, the temperature sane
   and no list overflow left;
6. where the time goes: each layer of the step timed alone, then
   torch.profiler over two production chunks (the device's busy time per
   step, its idle share, the top kernels and host ops);
7. lambda-window path: the 5,186-atom solvation box (n_side 12, 32^3 PME
   grid; below the size at which the JAX package buckets atoms for PME, so
   its spread and gather are the small-system TPU kernels K4/K5),
   equilibrated at window 10 of a 20-window ladder, then windows 10 and 11
   for 400 steps each with MTS2 and a Delta H sweep every 100 steps; the
   launch counters must match the flavour pattern, Delta H must be finite
   on exactly the sweep steps and ~0 for the own window; dhdl.xvg is
   written and read back and BAR's estimate of the 10 -> 11 leg printed;
8. K4/K5: spread and phi_gather at that path's shapes against their plain
   versions, with time, bound and index_add_ time; the foreign sweep's
   time and launch count;
9. NPT lambda window: from the window path's equilibrated state at window
   10, C-rescale (isotropic, tau_p 1 ps, ref_p 1 bar, compressibility
   4.5e-5 /bar, nstpcouple 10) with the dispersion correction (DispCorr =
   EnerPres): 1,000 NPT steps, then windows 10 and 11 for 400 steps each
   with a Delta H sweep every 100 steps -> dhdl.xvg -> BAR.  Each pressure
   step runs K1's virial flavour; the launch counters must match the
   flavour pattern exactly, the density stay in 0.90-1.10 g/cm^3 and the
   volume of the windows within 3 % of the equilibrated one.  The step
   and force of a pressure step ('R') are timed beside those of an 'F' and
   an 'E' step.  K1 VF+virial is held against its
   plain version at both paths' shapes (phases 4 and 9), and the small
   reference (phase 2) holds the cluster route's in-force virial on the
   card against the dense float64 oracle's strain gradient;
10. per-cluster kernels at the main path's shapes (phase 4's frame,
   geometric LJ, potential shift, rc 0.9): K7a ("super", union lists of 8
   clusters), K7b ("cluster"), K7c ("v2", baked shifts) and the table
   route's kernel, each in its flavours against its plain version (E rel
   1e-4, F rel 5e-4 of max |F|), each launch counted exactly once, with
   time, bound and plain time; then all five NB routes (K1, K7a, K7b, K7c,
   the table kernel in geometric mode) against each other at one state;
11. small CHARMM-style reference: a 650-atom box with the Lorentz-Berthelot
   table (force-switch, then potential-switch; rc 0.75 nm, rvdw-switch
   0.6 nm) on the default RunnerConfig, which demotes to the table route:
   GPU against CPU over 20 steps, then the GPU's final-frame energies,
   forces and Delta H against the dense float64 oracle at rel 1e-4;
12. the CHARMM path at 12,290 atoms: the main path's system with the
   Lorentz-Berthelot table and the GROMACS manual's CHARMM settings
   (force-switch, rvdw 1.2 nm, rvdw-switch 1.0 nm, PME rcoulomb 1.2 nm,
   DispCorr no), from the main path's production state: 500 steps of
   re-equilibration (tau_t 0.1 ps), the table kernel's F, VF and VF+virial
   against its plain version at these shapes (virial 1e-4 of max |Xi_aa|),
   400 production steps on the default RunnerConfig (every NB launch the
   table kernel's, launches as the flavour pattern says, the per-cluster
   capacity grown from 64 with its roll-backs printed, no overflow left,
   idle share under torch.profiler), then 100 C-rescale steps on the same
   route for its virial flavour;
13. each of the layouts "super", "cluster" and "v2" drives 100 steps of
   the main path from its production state, launches checked;
14. domain decomposition (DD) on a (2, 2, 2) grid of eight domains, all
   on the first card (the placement is printed; with more than one card
   the force check is repeated with the domains spread round-robin over
   them): K6 (the v2u body on each domain's halo-extended plane) in F and
   VF against its plain version at the main path's shapes, per domain;
   the whole DD force (K6 + sharded PME + FEP) against the single-domain
   force at the production state (Epot rel 1e-4, F rel 5e-4 of max |F|,
   dV/dlambda rel 1e-4 of max |dV/dlambda|); 400 MTS2 steps of the main
   path under DD with exact launch counts (K6 8 per step, K2/K3 8 per
   reciprocal step), ms/step and ns/day beside the single-domain figure;
   then the CHARMM path under DD (the table route's kernel on each
   domain's i-cluster range: F and VF against its plain version, then 100
   steps, launches exact);
15. 81,002 atoms (n_side 30, 9.3 nm box, 80^3 PME grid), first run at that
   size: the DD force against the single-domain force at the lattice
   start (the gates of 14), then 100 steps each of the single-domain and
   the DD runner with the equilibration parameters (dt 0.5 fs, tau_t 0.1
   ps), finite energies, no halo violation, ms/step of both.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Without a GPU it exits non-zero and
prints no result.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

N_SIDE = 16
N_SIDE_WINDOW = 12      # 1,727 waters + the ligand: 5,186 atoms
N_LAMBDA = 20
WINDOWS = (10, 11)
WINDOW_STEPS = 400
NPT_EQ_STEPS = 1000
DENSITY_BAND = (0.90, 1.10)     # g/cm^3
MAX_DV = 0.03                   # |V - V0| / V0 over the NPT windows
AMU_PER_NM3_IN_G_PER_CM3 = 1.66053906660e-3
EQ_STEPS = 2000        # 1 ps at dt 0.5 fs: the lattice start cools to ~300 K
PROD_STEPS = 400
REPS = 50               # kernel launches per timing
# gates of the reference fork (freeenergy.cpp:115-136)
E_REL, F_REL = 1e-4, 5e-4
# NVIDIA H100 SXM data sheet: fp32 non-tensor peak and HBM3 rate, at 700 W
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# flops per in-cutoff pair of K1 (bench.py:53 counts 66 for the same pair
# kernel); per atom for K2 (weights 3 x 24, 16 x (1 mul) + 64 x (mul, add))
# and for K3 (weights and derivative weights 3 x 30, 16 x 4 x 4 FMAs on
# the z taps, 16 x 4 x 3 flops for the x/y contractions)
FLOPS_PAIR = 66
# the table route's pair: exact erfc and exp, the table lookup and the
# force-switch polynomial
FLOPS_PAIR_TABLE = 80
# the kernels run full lists, which hold each pair twice; forces on every
# atom need each unique pair once plus the j atom's update (3 mul, 3 sub),
# so the operations bound counts unique pairs x (pair flops + 6)
FLOPS_JFORCE = 6
FLOPS_SPREAD_ATOM = 72 + 16 + 128
FLOPS_GATHER_ATOM = 90 + 256 + 192
TEMP_BAND = (260.0, 380.0)      # K, every production step
# the CHARMM path (GROMACS manual, "Force fields in GROMACS -> CHARMM")
CHARMM_RC, CHARMM_RSW = 1.2, 1.0
CHARMM_EQ_STEPS = 500
CHARMM_NPT_STEPS = 100
LAYOUT_STEPS = 100
# domain decomposition: the grid and block of mdrun -dd 2x2x2, the steps
# of each DD run, and the 81,002-atom system (26,999 waters + the ligand)
DD_GRID = (2, 2, 2)
DD_BLOCK = 8
DD_STEPS = 400
DD_CHARMM_STEPS = 100
N_SIDE_BIG = 30
BIG_STEPS = 100
K7_LAYOUTS = ("super", "cluster", "v2")
# TPU kernel each route replaces (file:line of the kernel body)
REPLACES = {"super": "gromacs_fep_gpu_tpu/ops/pallas_nb.py:90",
            "cluster": "gromacs_fep_gpu_tpu/ops/pallas_nb.py:227",
            "v2": "gromacs_fep_gpu_tpu/ops/pallas_nb.py:748",
            "table": "gromacs_fep_gpu_tpu/ops/cluster_nb.py:57",
            "table_dd": "gromacs_fep_gpu_tpu/ops/cluster_nb.py:112",
            "k6": "gromacs_fep_gpu_tpu/parallel/spatial.py:337"}


def _say(msg):
    print(msg, flush=True)


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


class DeviceTimer:
    """Device time of a launch: a sleep kernel holds the stream while the
    host enqueues `reps` calls, so host overhead stays outside the events.
    The median over `batches` such runs is returned."""

    def __init__(self):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = 20_000_000 / a.elapsed_time(b)

    def ms(self, fn, reps=REPS, batches=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        out = []
        for _ in range(batches):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(int(self.cycles_per_ms * (2.0 * host_ms + 5.0)))
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / reps)
        return statistics.median(out)


def _median_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _bound_ms(n_bytes, n_flops):
    t_b = n_bytes / PEAK_BYTES * 1e3
    t_o = n_flops / PEAK_FP32_FLOPS * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _rel(a, b):
    """max |a - b| / max |b| (and max |a - b|)."""
    d = float((a - b).abs().max())
    return d / max(float(b.abs().max()), 1e-30), d


def _params(mts, n_side=N_SIDE):
    """bench.py::_base_params(n_side, True, mts) of the JAX package."""
    from gromacs_fep_gpu_tpu_torch.core.types import (
        CoulombType, FepParams, MdParams, TcouplType)
    from gromacs_fep_gpu_tpu_torch.ops.pme import pme_grid_size
    box_l = n_side * 0.31
    return MdParams(
        dt=0.002, nstlist=20, coulomb=CoulombType.PME, rcoulomb=0.9,
        rvdw=0.9, rlist=0.9, pme_grid=pme_grid_size((box_l,) * 3, 0.12),
        tcoupl=TcouplType.V_RESCALE, ref_t=300.0, nsttcouple=10,
        nstcomm=100, nstcalcenergy=100, mts=mts,
        fep=FepParams(enabled=True, sc_alpha=0.5, sc_coul=True,
                      sc_sigma=0.3))


def _decoupled(state):
    lam = state.lam.clone()
    lam[2] = 0.5
    lam[3] = 0.5
    return state.replace(lam=lam)


def _pme_suffix(grid):
    """The PME counters are keyed by grid shape: the 12,290-atom path's
    grid reports as pme_spread / pme_gather, the window path's as
    pme_spread_small / pme_gather_small, the 81,002-atom system's as
    pme_spread_big / pme_gather_big."""
    return {tuple(_params(True).pme_grid): "",
            tuple(_params(True, N_SIDE_WINDOW).pme_grid): "_small",
            tuple(_params(True, N_SIDE_BIG).pme_grid): "_big"}[tuple(grid)]


PME_KEYS = tuple(f"pme_{k}{s}" for s in ("", "_small", "_big")
                 for k in ("spread", "gather"))


def _nb_counts():
    """NB launches: K1 as nb_v2u_<flavour>, the per-cluster kernel as
    nb_<layout>_<flavour>."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster, nb_v2u
    out = {f"nb_v2u_{k}": v for k, v in nb_v2u.launches.items()}
    for layout, by in nb_cluster.launches.items():
        out.update({f"nb_{layout}_{k}": v for k, v in by.items()})
    return out


def _counts():
    """Every kernel's launches since the last _zero_counts: the NB kernels
    (_nb_counts), the PME kernels by grid (the CHARMM path's grid is the
    main path's)."""
    from gromacs_fep_gpu_tpu_torch.ops import pme_kernels
    out = _nb_counts()
    out.update(dict.fromkeys(PME_KEYS, 0))
    for (kind, grid), n in pme_kernels.launches.items():
        out[f"pme_{kind}{_pme_suffix(grid)}"] += n
    return out


def _zero_counts():
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster, nb_v2u, pme_kernels
    for k in nb_v2u.launches:
        nb_v2u.launches[k] = 0
    for by in nb_cluster.launches.values():
        for k in by:
            by[k] = 0
    pme_kernels.launches.clear()


def _nb_prefix(runner):
    """The counter prefix of the runner's NB kernel: K6 under domain
    decomposition on the v2u layout, the table kernel's i-range launches
    on the other layouts, else the layout's kernel."""
    if runner.mesh is None:
        return f"nb_{runner.layout}_"
    return "nb_v2u_DD_" if runner.layout == "v2u" else "nb_table_dd_"


def _expected_counts(runner, start_step, nsteps):
    """Launches that the flavour pattern predicts: the runner's NB kernel
    (K1, or the per-cluster kernel of its layout) once per step (VF on the
    energy steps 'E' and 'D', VF+virial on the pressure steps 'R' and
    'S'), no other NB kernel, spread and gather once per step that is not
    an MTS off-step (a pressure step's reciprocal virial reuses its force
    pass's grid), and per foreign sweep ('D', 'S') two more spreads (qA of
    all atoms, dq of the perturbed ones) and one more gather.  Under
    domain decomposition the NB kernel and the spread and gather run once
    per domain."""
    pat = runner._flavor_pattern(start_step, nsteps)
    n_d = pat.count("D") + pat.count("S")
    sfx = _pme_suffix(runner.params.pme_grid)
    nsh = 1 if runner.mesh is None else len(runner.mesh.spatial_devices)
    out = dict.fromkeys(_nb_counts(), 0)
    out.update(dict.fromkeys(PME_KEYS, 0))
    nb = _nb_prefix(runner)
    out.update({nb + "F": nsh * (pat.count("F") + pat.count("f")),
                nb + "VF": nsh * (pat.count("E") + pat.count("D")),
                "pme_spread" + sfx: nsh * (nsteps - pat.count("f"))
                + 2 * n_d,
                "pme_gather" + sfx: nsh * (nsteps - pat.count("f")) + n_d})
    n_vir = pat.count("R") + pat.count("S")
    if n_vir or nb + "VFV" in out:
        out[nb + "VFV"] = n_vir
    return out


def _drive(runner, state, nsteps, what, volumes=None):
    """MdRunner.run with the counters zeroed just before and read just
    after; checks counts, finiteness and overflow flags.  With a list
    `volumes`, the run goes in calls of 100 steps and the box volume after
    each is appended to it."""
    from gromacs_fep_gpu_tpu_torch.md.runner import concat_logs
    expected = _expected_counts(runner, state.step, nsteps)
    pat = runner._flavor_pattern(state.step, nsteps)
    piece = nsteps if volumes is None else 100
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    logs, done = [], 0
    while done < nsteps:
        state, lg = runner.run(state, min(piece, nsteps - done))
        logs += lg
        done += min(piece, nsteps - done)
        if volumes is not None:
            volumes.append(torch.prod(torch.diagonal(state.box)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if volumes is not None:
        volumes[:] = [float(v) for v in volumes]
    counts = _counts()
    if counts != expected:
        raise AssertionError(f"{what}: launches {counts}, expected "
                             f"{expected}")
    lg = concat_logs(logs)
    on = torch.isfinite(lg.epot)
    n_on = int(on.sum())
    n_ener = sum(pat.count(f) for f in "EDRS")
    if n_on != n_ener:
        raise AssertionError(f"{what}: {n_on} energy steps, expected "
                             f"{n_ener}")
    if n_on and not bool(torch.isfinite(lg.dvdl[on]).all()):
        raise AssertionError(f"{what}: non-finite dV/dlambda")
    if not bool(torch.isfinite(state.x).all() & torch.isfinite(
            state.v).all()):
        raise AssertionError(f"{what}: non-finite coordinates")
    fl = runner.last_flags
    left = {k: fl[k] for k in ("fep_ovf", "s_ovf", "n_ovf", "excl_bad",
                               "shift_bad", "t_ovf", "halo_bad")}
    if any(left.values()):
        raise AssertionError(f"{what}: list flags after growth {left}")
    return state, lg, seconds, counts


def phase_build():
    """Build every source; per source, the kernels' register range and the
    bytes they spill (ptxas -v)."""
    import re
    from gromacs_fep_gpu_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()
    _say(f"build: {cuda_lib.build_seconds:.2f} s for "
         f"{len(cuda_lib.SOURCES)} sources")
    for stem, log in cuda_lib.build_logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
        _say(f"  {stem}.cu: {len(regs)} kernels, registers "
             f"{min(regs)}-{max(regs)}, {spill} bytes of spill stores and "
             f"loads")


def phase_small_reference(device):
    """The whole step on the GPU (kernels) against the CPU (plain
    versions): 650 atoms, 40 steps, two rebuilds, MTS2, no thermostat, at
    window 2 of a 5-window ladder with a Delta H sweep every 20 steps.
    Gates: positions 2e-4 nm; potential energy and dV/dlambda 1e-4 of the
    reciprocal energy's magnitude (a sum of large terms of both signs;
    atomics and summation order differ, and 40 steps amplify that); Delta H
    1e-4 of max |Delta H|, own window <= 1e-3 kJ/mol.  Then the GPU's
    Delta H on its final frame (cluster route: FEP list, lambda-dependent
    terms, reciprocal slope, float32) against the dense oracle on the same
    coordinates (differences of the whole potential, float64, on the CPU:
    the CUDA kernels are float32 only), rel 1e-4 of max |Delta H|."""
    from gromacs_fep_gpu_tpu_torch.core.types import TcouplType
    from gromacs_fep_gpu_tpu_torch.md.runner import (MdRunner, RunnerConfig,
                                                     concat_logs)
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    from gromacs_fep_gpu_tpu_torch.ops.forces import dense_energy, get_beta
    from gromacs_fep_gpu_tpu_torch.ops.pme import pme_grid_size
    from gromacs_fep_gpu_tpu_torch.parallel.ensemble import lambda_schedule
    n_side, window = 6, 2
    ladder = lambda_schedule(5)
    params = _params(mts=True).replace(
        dt=0.001, rcoulomb=0.6, rvdw=0.6, rlist=0.6,
        pme_grid=pme_grid_size((n_side * 0.31,) * 3, 0.12),
        tcoupl=TcouplType.NO, nstcalcenergy=20)
    params = params.replace(fep=dataclasses.replace(params.fep, nstdhdl=20))
    out = {}
    for dev in (device, "cpu"):
        system, state = solvation_system(n_side=n_side, seed=0, device=dev)
        state = state.replace(lam=torch.tensor(ladder[window], device=dev),
                              fep_state=window)
        runner = MdRunner(system, params, RunnerConfig(
            super_nnbr=128, fep_max_nbr=128, baked_shifts=False),
            all_lambda=ladder)
        state, logs = runner.run(state, 40)
        out[dev] = (state, concat_logs(logs), runner)
    (sg, lgg, run_g), (sc, lgc, run_c) = out[device], out["cpu"]
    dx = float((sg.x.cpu() - sc.x).abs().max())
    on = torch.isfinite(lgc.epot)
    scale = float(lgc.epot[on].abs().max())
    de = float((lgg.epot.cpu()[on] - lgc.epot[on]).abs().max())
    dl = float((lgg.dvdl.cpu()[on][:, 2:4] - lgc.dvdl[on][:, 2:4]).abs()
               .max())
    _say(f"small reference (650 atoms, 40 steps): max|dx| {dx:.3e} nm, "
         f"max|dEpot| {de:.3e}, max|d dvdl| {dl:.3e} (scale {scale:.1f})")
    if not (dx <= 2e-4 and de <= 1e-4 * scale and dl <= 1e-4 * scale):
        raise AssertionError("small reference: GPU run disagrees with CPU")
    dh_g, dh_c = lgg.delta_h.cpu(), lgc.delta_h
    swept = torch.isfinite(dh_c[:, 0])
    if swept.tolist() != [i % 20 == 0 for i in range(40)] or not torch.equal(
            torch.isfinite(dh_g), torch.isfinite(dh_c)):
        raise AssertionError("small reference: Delta H is not finite on "
                             "exactly the nstdhdl steps")
    dh_rel, dh_abs = _rel(dh_g[swept], dh_c[swept])
    own = float(dh_g[swept][:, window].abs().max())
    _say(f"small reference, ladder of 5 at window {window}: Delta H GPU vs "
         f"CPU rel {dh_rel:.2e} (abs {dh_abs:.2e} of "
         f"{float(dh_c[swept].abs().max()):.3f} kJ/mol), own window "
         f"{own:.2e}")
    if not (dh_rel <= E_REL and own <= 1e-3):
        raise AssertionError("small reference: Delta H disagrees")

    # the GPU's sweep on its final frame against the dense oracle
    _, feplist, _, _ = run_g.rebuild(sg)
    dh_k = run_g._foreign(feplist)(sg.x, sg.box, sg.lam).cpu().double()
    x64, box64 = sg.x.cpu().double(), sg.box.cpu().double()
    beta = get_beta(params)
    with torch.no_grad():
        e = [dense_energy(x64, box64, lm, run_c.system, params, beta,
                          run_c.recip_fn).epot
             for lm in list(torch.tensor(ladder).double())
             + [sg.lam.cpu().double()]]
    oracle = torch.stack(e[:-1]) - e[-1]
    o_rel, o_abs = _rel(dh_k, oracle)
    _say(f"Delta H, cluster route on the GPU (float32) vs dense oracle "
         f"(float64): {[round(float(v), 4) for v in dh_k]} vs "
         f"{[round(float(v), 4) for v in oracle]} kJ/mol, rel {o_rel:.2e} "
         f"(abs {o_abs:.2e})")
    if not o_rel <= E_REL:
        raise AssertionError("Delta H disagrees with the dense oracle")

    # the in-force virial of a pressure step (K1 VF+virial, strain
    # gradient of the cheap terms, reciprocal strain derivative on the
    # force pass's grid) with the dispersion correction on, on the GPU's
    # final frame, against the strain gradient of the whole dense potential
    # in float64 on the CPU; gate 2e-4 of max |Xi_aa| (the JAX package's,
    # tests/test_virial.py)
    from gromacs_fep_gpu_tpu_torch.md.simulator import make_pressure_fn
    from gromacs_fep_gpu_tpu_torch.ops import nb_v2u, pme_kernels
    vparams = params.replace(dispcorr=True)
    vrun = MdRunner(run_g.system, vparams, RunnerConfig(
        super_nnbr=128, fep_max_nbr=128, baked_shifts=False))
    nlist, feplist, prep, _ = vrun.rebuild(sg)
    torch.cuda.synchronize()
    _zero_counts()
    _, terms = vrun._force_fn(sg.x, sg.box, sg.lam, nlist, feplist, prep,
                              need_virial=True)
    torch.cuda.synchronize()
    k1, pme_by_kind = dict(nb_v2u.launches), {}
    for (kind, _), n in pme_kernels.launches.items():
        pme_by_kind[kind] = pme_by_kind.get(kind, 0) + n
    if (k1, pme_by_kind) != (dict(dict.fromkeys(k1, 0), VFV=1),
                             {"spread": 1, "gather": 1}):
        raise AssertionError(f"a pressure step's force launched {k1}, "
                             f"{pme_by_kind}: expected one K1 VF+virial, "
                             "one spread and one gather")
    vir_k = terms.vir_diag.cpu().double()

    def epot(x, box, lam):
        return dense_energy(x, box, lam, run_c.system, vparams, beta,
                            run_c.recip_fn).epot
    _, _, vir_o = make_pressure_fn(epot)(
        x64, box64, sg.lam.cpu().double(), torch.zeros_like(x64),
        run_c.system.mass_a.double())
    v_rel, v_abs = _rel(vir_k, vir_o)
    _say(f"virial, cluster route on the GPU (float32, K1 VF+virial) vs "
         f"dense oracle (float64): {[round(float(v), 3) for v in vir_k]} "
         f"vs {[round(float(v), 3) for v in vir_o]} kJ/mol, rel "
         f"{v_rel:.2e} (abs {v_abs:.2e})")
    if not v_rel <= 2e-4:
        raise AssertionError("the in-force virial disagrees with the dense "
                             "oracle")


def phase_kernels(runner, state, timer):
    """Each kernel against its plain version at the main path's shapes
    (K1 F and VF, which the path runs, and K1 VF+virial, checked here at
    these shapes as well; its row comes from the NPT path's shapes)."""
    rows = _k1_kernel_rows(runner, state, timer, ("F", "VF", "VFV"))
    rows = [r for r in rows if r["name"] != "nb_v2u_VFV"]
    system, params = runner.system, runner.params
    lam_c = float(state.lam[2])
    q = ((1.0 - lam_c) * system.charge_a + lam_c * system.charge_b
         ).contiguous()
    rows += _pme_kernel_rows(state.x, state.box, q, params, timer,
                             small=False)
    return rows


def _k1_kernel_rows(runner, state, timer, flavours):
    """K1 in each flavour ('F', 'VF', 'VFV') against its plain version on
    one frame of `runner`'s path.  Gates: forces rel 5e-4, energies rel
    1e-4, the virial Xi_aa = -1/4 sum of the per-block partials (float64
    sum) rel 1e-4 of max |Xi_aa|."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_v2u
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    params = runner.params
    x, box = state.x, state.box
    nlist, _, prep, fl = runner.lists(state)
    consts = nb_v2u.NbConstants.from_params(params, get_beta(params))
    ip, jp = nb_v2u.gather_coordinates(x, box, nlist, prep)
    S, G = prep.nbr2.shape[:2]
    rows = []

    # K1 work of this pair list: masked pairs inside the cut-off, each
    # unique pair counted once
    n_pairs = 0
    live_groups = int(prep.ng.sum())
    ixyz = [p.reshape(S, -1, 1) for p in ip]
    bit = torch.arange(32, device=x.device, dtype=torch.int32).reshape(1, -1, 1)
    bl = torch.diagonal(box)
    for g in range(G):
        pair = ((prep.pair_m[:, g, None, :] >> bit) & 1).bool() \
            & (g < prep.ng)[:, None, None]
        d = [ixyz[a] - jp[a][:, g, None, :] for a in range(3)]
        if prep.shift is None:      # the in-kernel minimum image
            d = [d[a] - torch.round(d[a] / bl[a]) * bl[a] for a in range(3)]
        r2 = sum(da * da for da in d)
        n_pairs += int((pair & (r2 < consts.rc2)).sum())
    n_pairs //= 2
    k1_bytes = (6 * S * 32 + 8 * live_groups * 256 + S) * 4 + 36 \
        + (3 * S * 32 + 2 * S) * 4
    for flavour in flavours:
        name = "nb_v2u_" + flavour
        energy, virial = flavour != "F", flavour == "VFV"

        def kern(e=energy, v=virial):
            return nb_v2u.nb_v2u_cuda(ip, jp, box, prep, consts, e, v)

        def plain(e=energy, v=virial):
            return nb_v2u.nb_v2u_plain(ip, jp, box, prep, consts, e, v)
        fk, fp = kern(), plain()
        torch.cuda.synchronize()
        f_k = torch.stack(fk[:3], -1)
        f_p = torch.stack(fp[:3], -1)
        f_rel, f_abs = _rel(f_k, f_p)
        e_rel = v_rel = 0.0
        if energy:
            ek, ep = 0.5 * fk[3][:, :2].sum(0), 0.5 * fp[3][:, :2].sum(0)
            e_rel = float(((ek - ep).abs() / ep.abs()).max())
        if virial:
            vk, vp = (-0.25 * e[3][:, 2:5].double().sum(0) for e in (fk, fp))
            v_rel, v_abs = _rel(vk, vp)
            f_abs = max(f_abs, v_abs)
        ok = f_rel <= F_REL and e_rel <= E_REL and v_rel <= E_REL
        ms = timer.ms(kern)
        plain_ms = _median_ms(plain, reps=3)
        # the virial flavour writes 3 more floats per block and does 9
        # more flops per pair
        bound, by = _bound_ms(k1_bytes + (12 * S if virial else 0),
                              n_pairs * (FLOPS_PAIR + FLOPS_JFORCE
                                         + (9 if virial else 0)))
        _say(f"{name} ({x.shape[0]:,} atoms): S={S} G={G} live "
             f"groups {live_groups} unique pairs in cut-off {n_pairs}; F "
             f"rel "
             f"{f_rel:.2e}, E rel {e_rel:.2e}, virial rel {v_rel:.2e} -> "
             f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms (plain {plain_ms:.3f} "
             f"ms, bound {bound:.5f} ms by {by})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        rows.append(dict(
            name=name, route="cuda",
            source="gromacs_fep_gpu_tpu_torch/csrc/nb_v2u.cu",
            replaces="gromacs_fep_gpu_tpu/ops/pallas_nb.py:1107",
            max_abs_err=f_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None))
    return rows


def _pme_kernel_rows(x, box, q, params, timer, small):
    """Spread and gather at one path's shapes against their plain versions
    (the lambda-mixed charges of the step).  small=False: K2/K3 of the
    12,290-atom path, the kernel wrappers against spread_plain and
    gather_plain.  small=True: K4/K5 of the window path, through the entry
    points that stand for the small-system TPU kernels, _spread_dispatch
    and phi_gather, the latter against its einsum body."""
    from gromacs_fep_gpu_tpu_torch.ops import pme, pme_kernels
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    K = tuple(params.pme_grid)
    sfx = "_small" if small else ""
    n = x.shape[0]
    ng = K[0] * K[1] * K[2]
    rows = []
    if small:
        def spread():
            return pme._spread_dispatch(x, box, q, K, params.pme_order)
    else:
        def spread():
            return pme_kernels.spread_cuda(x, box, q, K)
    before = pme_kernels.launches["spread", K]
    g_k = spread()
    if pme_kernels.launches["spread", K] != before + 1:
        raise AssertionError(f"pme_spread{sfx}: the entry point did not "
                             "launch the spread kernel")
    g_p = pme_kernels.spread_plain(x, box, q, K)
    torch.cuda.synchronize()
    s_rel, s_abs = _rel(g_k, g_p)
    ms = timer.ms(spread)
    plain_ms = _median_ms(lambda: pme_kernels.spread_plain(x, box, q, K))
    # library yardstick: the index_add_ of the 64 taps, weights given
    _, (i0, i1, i2), (wx, wy, wz), _ = pme_kernels._support(x, box, K)
    flat = ((i0[:, :, None, None] * K[1] + i1[:, None, :, None]) * K[2]
            + i2[:, None, None, :]).reshape(-1)
    val = (q[:, None, None, None] * wx[:, :, None, None]
           * wy[:, None, :, None] * wz[:, None, None, :]).reshape(-1)
    lib_ms = timer.ms(lambda: torch.zeros(ng, device=x.device).index_add_(
        0, flat, val))
    memset_ms = timer.ms(lambda: torch.zeros(K, device=x.device))
    bound, by = _bound_ms(16 * n + 4 * ng + 36, FLOPS_SPREAD_ATOM * n)
    # the kernel's atomics add in an order that changes from run to run:
    # the grid is held at the energy gate, rel 1e-4 of its largest value
    ok = s_rel <= E_REL
    _say(f"pme_spread{sfx}: n={n} grid {K}; grid rel {s_rel:.2e} -> "
         f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms, of which the grid's "
         f"memset {memset_ms:.4f} ms (plain {plain_ms:.3f} ms, index_add_ "
         f"{lib_ms:.4f} ms, bound {bound:.5f} ms by {by})")
    if not ok:
        raise AssertionError(f"pme_spread{sfx} disagrees with its plain "
                             "version")
    rows.append(dict(
        name="pme_spread" + sfx, route="cuda",
        source="gromacs_fep_gpu_tpu_torch/csrc/pme_spline.cu",
        replaces=("gromacs_fep_gpu_tpu/ops/pme_pallas.py:112" if small
                  else "gromacs_fep_gpu_tpu/ops/pme_blocked.py:394"),
        max_abs_err=s_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms))

    influence = pme.influence_tensors(
        pme.make_influence_function(K, params.pme_order), x.device)
    _, phi = pme.energy_and_potential(g_p, box, get_beta(params), influence)
    if small:
        before = pme_kernels.launches["gather", K]
        f_k, d_k = pme.phi_gather(x, box, q, phi, K, params.pme_order)
        if pme_kernels.launches["gather", K] != before + 1:
            raise AssertionError("pme_gather_small: phi_gather did not "
                                 "launch the gather kernel")
        f_p, d_p = pme.phi_gather_plain(x, box, q, phi, K, params.pme_order)

        def plain():
            return pme.phi_gather_plain(x, box, q, phi, K, params.pme_order)
    else:
        o_k = pme_kernels.gather_cuda(x, box, q, phi)
        o_p = pme_kernels.gather_plain(x, box, q, phi)
        (f_k, d_k), (f_p, d_p) = ((o[:, :3], o[:, 3]) for o in (o_k, o_p))

        def plain():
            return pme_kernels.gather_plain(x, box, q, phi)
    torch.cuda.synchronize()
    gf_rel, gf_abs = _rel(f_k, f_p)
    gq_rel, gq_abs = _rel(d_k, d_p)
    ms = timer.ms(lambda: pme_kernels.gather_cuda(x, box, q, phi))
    plain_ms = _median_ms(plain)
    bound, by = _bound_ms(16 * n + 4 * ng + 36 + 16 * n,
                          FLOPS_GATHER_ATOM * n)
    ok = gf_rel <= F_REL and gq_rel <= E_REL
    _say(f"pme_gather{sfx}: force rel {gf_rel:.2e}, dE/dq rel {gq_rel:.2e} "
         f"-> {'ok' if ok else 'FAIL'}; {ms:.4f} ms (plain {plain_ms:.3f} "
         f"ms, bound {bound:.5f} ms by {by})")
    if not ok:
        raise AssertionError(f"pme_gather{sfx} disagrees with its plain "
                             "version")
    rows.append(dict(
        name="pme_gather" + sfx, route="cuda",
        source="gromacs_fep_gpu_tpu_torch/csrc/pme_spline.cu",
        replaces=("gromacs_fep_gpu_tpu/ops/pme_pallas.py:170" if small
                  else "gromacs_fep_gpu_tpu/ops/pme_blocked.py:447"),
        max_abs_err=max(gf_abs, gq_abs), ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None))
    return rows


def phase_profile(runner, state, nsteps, ms_step):
    """Where the time goes.  First the wall time of each layer of the step,
    called alone at the main path's shapes (CUDA events around the call:
    the larger of host and device time).  Then torch.profiler over `nsteps`
    production steps (two pair-list rebuilds): the device's busy time is
    the sum of its kernels' times (one stream, so they do not overlap) and
    the idle share is taken against the unprofiled ms/step of the
    production phase."""
    from gromacs_fep_gpu_tpu_torch.md.constraints import settle_positions
    from gromacs_fep_gpu_tpu_torch.md.simulator import masses_at_lambda

    system, ff = runner.system, runner._force_fn
    x, box, lam = state.x, state.box, state.lam
    nlist, feplist, prep, _ = runner.rebuild(state)
    step = runner.step_fn(nlist, feplist, prep)
    rs = float(runner.params.mts_factor)
    _, invmass = masses_at_lambda(system, lam[1])
    x1 = x + runner.params.dt * state.v
    layers = {
        "step F (MTS on-step)": lambda: step(state, "F"),
        "step f (MTS off-step)": lambda: step(state, "f"),
        "pair-list rebuild (1 in nstlist steps)":
            lambda: runner.rebuild(state),
        "force F (K1 + FEP/bonded autograd + PME)":
            lambda: ff(x, box, lam, nlist, feplist, prep,
                       need_energy=False, recip_scale=rs),
        "force f (K1 + FEP/bonded autograd)":
            lambda: ff(x, box, lam, nlist, feplist, prep,
                       need_energy=False, skip_recip=True),
        "force E (energies and dV/dl)":
            lambda: ff(x, box, lam, nlist, feplist, prep,
                       need_energy=True, recip_scale=rs),
        "PME reciprocal (K2 + FFT + K3 + E[dq])":
            lambda: runner.recip_force_fn(x, box, lam[2]),
        "SETTLE": lambda: settle_positions(x, x1, box, system.settle,
                                           invmass),
    }
    for name, fn in layers.items():
        _say(f"  layer {name}: {_median_ms(fn):.3f} ms")
    _profile_window(runner, state, nsteps, ms_step)


def _profile_window(runner, state, nsteps, ms_step, top=10):
    """torch.profiler over `nsteps` steps of runner.run: the device's busy
    time (the sum of its kernels' times: one stream, so they do not
    overlap), its idle share against the unprofiled ms/step, the top
    kernels and host ops.  Returns the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(state, nsteps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    # device-side events only: the host ops that launched them report the
    # same time again
    ev = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    n_kern = sum(e.count for e in ev)
    _say(f"profile ({nsteps} steps): device busy {busy_ms / nsteps:.3f} "
         f"ms/step in {n_kern / nsteps:.0f} kernels/step; wall under "
         f"the profiler {wall_ms / nsteps:.3f} ms/step; idle share "
         f"{1.0 - busy_ms / nsteps / ms_step:.3f} of the unprofiled "
         f"{ms_step:.3f} ms/step")
    ev.sort(key=lambda e: -e.self_device_time_total)
    for e in ev[:top]:
        _say(f"  {e.self_device_time_total / 1e3 / nsteps:9.4f} ms/step "
             f"{e.count / nsteps:6.1f}/step  {e.key[:90]}")
    cpu = sorted((e for e in avg if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)
    _say("  host: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3 / nsteps:.2f} ms/step"
        for e in cpu[:8]))
    return 1.0 - busy_ms / nsteps / ms_step


def _run_windows(runner_for, start, params, ladder, smi, what,
                 volumes=None):
    """Windows WINDOWS, each WINDOW_STEPS from `start` (set to the window)
    through _drive, with their checks: Delta H finite on exactly the sweep
    steps, own window ~0, temperature in its band; dhdl.xvg of each window
    written and read back; BAR of the leg printed.  Returns (launches
    summed over the windows, the last window's final state, its log)."""
    from gromacs_fep_gpu_tpu_torch.analysis.bar import bar_profile
    from gromacs_fep_gpu_tpu_torch.core.units import BOLTZ
    from gromacs_fep_gpu_tpu_torch.io.xvgio import read_xvg, write_dhdl_xvg
    device = start.x.device
    total = {}
    dh_rows, idx_rows, ti = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        for w in WINDOWS:
            runner = runner_for(seed=w)
            state, lg, sec, counts = _drive(
                runner, start.replace(
                    lam=torch.tensor(ladder[w], device=device), fep_state=w,
                    step=0), WINDOW_STEPS, f"{what} {w}", volumes)
            pat = runner._flavor_pattern(0, WINDOW_STEPS)
            swept = torch.tensor([c in "DS" for c in pat], device=device)
            dh = lg.delta_h
            if dh.shape != (WINDOW_STEPS, N_LAMBDA) or not torch.equal(
                    torch.isfinite(dh), swept[:, None].expand_as(dh)):
                raise AssertionError(f"{what} {w}: Delta H is not finite on "
                                     "exactly the sweep steps")
            own = float(dh[swept][:, w].abs().max())
            t_lo, t_hi = float(lg.temp.min()), float(lg.temp.max())
            ms_step = sec / WINDOW_STEPS * 1e3
            ns_day = WINDOW_STEPS * params.dt / 1000.0 / sec * 86400.0
            flavours = {c: pat.count(c) for c in sorted(set(pat))}
            _say(f"{what} {w} (MTS2, dt 2 fs, {int(swept.sum())} sweeps of "
                 f"{N_LAMBDA}): {WINDOW_STEPS} steps, {ms_step:.3f} ms/step, "
                 f"{ns_day:.2f} ns/day on {smi}; flavours {flavours}; "
                 f"launches {counts}; regrows {runner.n_regrow}; T "
                 f"{t_lo:.1f}..{t_hi:.1f} K; own-window |Delta H| "
                 f"{own:.2e}; Delta H to the neighbours "
                 f"{[[round(float(v), 3) for v in r] for r in dh[swept][:, w - 1:w + 2]]}")
            if own > 1e-3:
                raise AssertionError(f"{what} {w}: own-window Delta H {own}")
            if not (TEMP_BAND[0] <= t_lo and t_hi <= TEMP_BAND[1]):
                raise AssertionError(f"{what} {w}: temperature left "
                                     f"{TEMP_BAND} K: {t_lo:.1f}..{t_hi:.1f}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            # dhdl.xvg of the sweep steps, written and read back
            path = f"{tmp}/window{w}.dhdl.xvg"
            times = torch.nonzero(swept)[:, 0].cpu().numpy() * params.dt
            write_dhdl_xvg(path, times, lg.dvdl[swept].cpu().numpy(),
                           dh[swept].cpu().numpy(), ladder, w,
                           temperature=params.ref_t)
            data, legends = read_xvg(path)
            if data.shape != (int(swept.sum()), 1 + 3 + N_LAMBDA) \
                    or len(legends) != 3 + N_LAMBDA:
                raise AssertionError(f"{what} {w}: dhdl.xvg came back as "
                                     f"{data.shape}, {len(legends)} legends")
            dh_rows.append(data[:, 4:])
            idx_rows.append([w] * data.shape[0])
            ti.append(float(data[:, 1:4].sum(1).mean()))
    with warnings.catch_warnings():
        # only two of the twenty windows were run: the other legs are empty
        warnings.simplefilter("ignore", UserWarning)
        legs, _, _ = bar_profile(np.concatenate(dh_rows),
                                 np.concatenate(idx_rows), params.ref_t,
                                 skip_frac=0.0)
    dg, err = legs[WINDOWS[0]]
    dlam = float(ladder[WINDOWS[1], 2] - ladder[WINDOWS[0], 2])
    _say(f"{what}: free energy of the leg {WINDOWS[0]} -> {WINDOWS[1]} from "
         f"{len(idx_rows[0])} + {len(idx_rows[1])} samples (a print, not a "
         f"gate): BAR {dg:.4f} +- {err:.4f} kJ/mol; <dV/dl> dlambda "
         f"{0.5 * (ti[0] + ti[1]) * dlam:.4f} kJ/mol (kT "
         f"{BOLTZ * params.ref_t:.3f})")
    return total, state, lg


def phase_window(device, timer, smi):
    """The lambda-window free-energy run at full width: 5,186 atoms, a
    20-window ladder, windows 10 and 11.  Returns the K4/K5 rows with their
    launches on this path, this path's launches, and (system, the
    equilibrated state at window 10, the list capacities) for the NPT
    phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    from gromacs_fep_gpu_tpu_torch.parallel.ensemble import lambda_schedule

    ladder = lambda_schedule(N_LAMBDA)
    params = _params(mts=True, n_side=N_SIDE_WINDOW)
    if params.fep.nstdhdl != params.nstcalcenergy:
        raise AssertionError("window path: nstdhdl != nstcalcenergy")
    system, state = solvation_system(n_side=N_SIDE_WINDOW, seed=0,
                                     device=device)

    def at_window(st, w):
        return st.replace(lam=torch.tensor(ladder[w], device=device),
                          fep_state=w, step=0)
    _say(f"window system: {system.n_atoms} atoms, box "
         f"{float(state.box[0, 0]):.2f} nm, PME grid {params.pme_grid}, "
         f"ladder of {N_LAMBDA}, nstdhdl {params.fep.nstdhdl}")
    eq_params = _params(mts=False, n_side=N_SIDE_WINDOW).replace(
        dt=0.0005, tau_t=0.1, nsttcouple=1)
    eq = MdRunner(system, eq_params, RunnerConfig(super_nnbr=448,
                                                  fep_max_nbr=512))
    state, lg, sec, counts = _drive(eq, at_window(state, WINDOWS[0]),
                                    EQ_STEPS, "window equilibration")
    _say(f"window equilibration at window {WINDOWS[0]}: {EQ_STEPS} steps in "
         f"{sec:.2f} s, regrows {eq.n_regrow}, final T "
         f"{float(lg.temp[-1]):.1f} K")
    eq_state = state

    def runner_for(seed):
        return MdRunner(system, params, RunnerConfig(
            super_nnbr=eq.config.super_nnbr,
            fep_max_nbr=eq.config.fep_max_nbr, seed=seed), all_lambda=ladder)

    # K4/K5 at this path's shapes, on the equilibrated frame
    lam_c = float(ladder[WINDOWS[0], 2])
    q = ((1.0 - lam_c) * system.charge_a + lam_c * system.charge_b
         ).contiguous()
    rows = _pme_kernel_rows(eq_state.x, eq_state.box, q, params, timer,
                            small=True)

    total, state, _ = _run_windows(runner_for, eq_state, params, ladder, smi,
                                   "window")

    # the foreign sweep alone: time and launches
    runner = runner_for(seed=0)
    _, feplist, _, _ = runner.rebuild(state)
    sweep = runner._foreign(feplist)
    sweep_ms = _median_ms(lambda: sweep(state.x, state.box, state.lam))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sweep(state.x, state.box, state.lam)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    _say(f"foreign sweep (L = {N_LAMBDA}, {system.n_atoms} atoms): "
         f"{sweep_ms:.3f} ms per sweep, {sum(e.count for e in ev)} kernels, "
         f"device busy {sum(e.self_device_time_total for e in ev) / 1e3:.3f} "
         f"ms, on {smi}")
    for r in rows:
        r["launches"] = total[r["name"]]
    caps = (eq.config.super_nnbr, eq.config.fep_max_nbr)
    return rows, total, (system, eq_state, caps)


def phase_npt(timer, smi, system, eq_state, caps):
    """The NPT lambda window at full width: the window path's system and
    parameters with C-rescale and the dispersion correction (the GROMACS
    free-energy tutorial's NPT settings with DispCorr = EnerPres), from its
    equilibrated state at window 10: NPT_EQ_STEPS steps, then windows 10
    and 11.  Gates: exact launches (checked by _drive against the flavour
    pattern, and the pattern against the expected flavour counts: per
    window S 4, R 36, F 160, f 200; equilibration R 100, F 400, f 500),
    finite values, density in DENSITY_BAND at every sample, and the
    windows' volumes within MAX_DV of V_eq, the volume after the NPT
    equilibration.  The NVT-equilibrated start is ~2 % denser than TIP3P
    at 1 bar with the tail correction; the 1,000 NPT steps relax it, and
    the drift from the NVT volume is printed, not gated.  Returns the K1
    VF+virial row (measured at this path's shapes) and the launches."""
    from gromacs_fep_gpu_tpu_torch.core.types import PcouplType
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.parallel.ensemble import lambda_schedule

    ladder = lambda_schedule(N_LAMBDA)
    params = _params(mts=True, n_side=N_SIDE_WINDOW).replace(
        pcoupl=PcouplType.C_RESCALE, pcoupltype="isotropic", tau_p=1.0,
        ref_p=1.0, compressibility=4.5e-5, nstpcouple=10, dispcorr=True)
    mass = float(system.mass_a.sum())

    def density(vol):
        return mass / vol * AMU_PER_NM3_IN_G_PER_CM3

    def runner_for(seed, all_lambda=ladder):
        return MdRunner(system, params, RunnerConfig(
            super_nnbr=caps[0], fep_max_nbr=caps[1], seed=seed),
            all_lambda=all_lambda)
    v0 = float(torch.prod(torch.diagonal(eq_state.box)))
    _say(f"NPT window: {system.n_atoms} atoms, C-rescale tau_p "
         f"{params.tau_p} ps, ref_p {params.ref_p} bar, compressibility "
         f"{params.compressibility} /bar, nstpcouple {params.nstpcouple}, "
         f"DispCorr EnerPres; V0 {v0:.4f} nm^3, density "
         f"{density(v0):.4f} g/cm^3")

    eq = runner_for(seed=100, all_lambda=None)
    pat = eq._flavor_pattern(0, NPT_EQ_STEPS)
    want = {"R": 100, "F": 400, "f": 500}
    if {c: pat.count(c) for c in set(pat)} != want:
        raise AssertionError(f"NPT equilibration flavours {pat!r}")
    vols = []
    state, lg, sec, counts = _drive(eq, eq_state.replace(step=0),
                                    NPT_EQ_STEPS, "NPT equilibration", vols)
    p_on = lg.pres[torch.isfinite(lg.pres)]
    _say(f"NPT equilibration at window {WINDOWS[0]}: {NPT_EQ_STEPS} steps, "
         f"{sec / NPT_EQ_STEPS * 1e3:.3f} ms/step, launches {counts}; "
         f"volume every 100 steps {[round(v, 4) for v in vols]} nm^3; mean "
         f"P {float(p_on.mean()):.1f} bar over {p_on.numel()} pressure "
         f"steps")
    if counts["nb_v2u_VFV"] != 100 or counts["nb_v2u_F"] != 900:
        raise AssertionError(f"NPT equilibration launches {counts}")

    for w in WINDOWS:
        pat = runner_for(seed=w)._flavor_pattern(0, WINDOW_STEPS)
        if {c: pat.count(c) for c in set(pat)} != {"S": 4, "R": 36,
                                                   "F": 160, "f": 200}:
            raise AssertionError(f"NPT window {w} flavours {pat!r}")
    wvols = []
    total, state_w, lg_w = _run_windows(runner_for, state, params, ladder,
                                        smi, "NPT window", wvols)
    if total["nb_v2u_VFV"] != 80 or total["nb_v2u_F"] != 720 \
            or total["nb_v2u_VF"] != 0:
        raise AssertionError(f"NPT windows launches {total}")
    p_on = lg_w.pres[torch.isfinite(lg_w.pres)]
    all_v = vols + wvols
    v_eq = vols[-1]
    dv = max(abs(v - v_eq) for v in wvols) / v_eq
    rho = density(all_v[-1])
    _say(f"NPT windows: volume every 100 steps {[round(v, 4) for v in wvols]}"
         f" nm^3; window {WINDOWS[-1]} mean P {float(p_on.mean()):.1f} bar "
         f"over {p_on.numel()} pressure steps; final density {rho:.4f} "
         f"g/cm^3; max |V - V_eq| / V_eq {dv:.4f} over the windows; drift "
         f"from the NVT volume: final {(all_v[-1] - v0) / v0:+.4f}, largest "
         f"{max(abs(v - v0) for v in all_v) / v0:.4f}")
    if not bool(torch.isfinite(p_on).all()) or p_on.numel() != 40:
        raise AssertionError("NPT window: pressure not finite on exactly "
                             "the 40 pressure steps")
    if not DENSITY_BAND[0] <= rho <= DENSITY_BAND[1] or not all(
            DENSITY_BAND[0] <= density(v) <= DENSITY_BAND[1] for v in all_v):
        raise AssertionError(f"NPT density left {DENSITY_BAND} g/cm^3")
    if dv >= MAX_DV:
        raise AssertionError(f"NPT volume moved by {dv:.4f} of V_eq")

    # the cost of a pressure step: step and force of each flavour alone
    runner = runner_for(seed=0)
    nlist, feplist, prep, _ = runner.rebuild(state)
    step = runner.step_fn(nlist, feplist, prep)
    ff, x, box, lam = runner._force_fn, state.x, state.box, state.lam
    rs = float(params.mts_factor)
    layers = {
        "step R (pressure step)": lambda: step(state.replace(step=0), "R"),
        "step F (MTS on-step)": lambda: step(state.replace(step=1), "F"),
        "force R (energies, dV/dl, virial)": lambda: ff(
            x, box, lam, nlist, feplist, prep, need_virial=True,
            recip_scale=rs),
        "force E (energies, dV/dl)": lambda: ff(
            x, box, lam, nlist, feplist, prep, recip_scale=rs),
        "force F": lambda: ff(x, box, lam, nlist, feplist, prep,
                              need_energy=False, recip_scale=rs),
    }
    for name, fn in layers.items():
        _say(f"  NPT layer {name}: {_median_ms(fn):.3f} ms")

    # K1 VF+virial at this path's shapes, on the NPT-equilibrated frame
    rows = _k1_kernel_rows(runner_for(seed=0), state, timer, ("VFV",))
    rows[0]["launches"] = total["nb_v2u_VFV"]
    return rows, total



def _lb_system(n_side, device):
    """The solvation model's system with its sigma/epsilon mixed by
    Lorentz-Berthelot (comb-rule 2, the AMBER/CHARMM rule) and the model's
    zeroed rows for the water H and the dummy type, from the public
    builders; its state is solvation_system's."""
    from gromacs_fep_gpu_tpu_torch.core.topology import (
        build_system, lj_table_from_sigma_eps)
    from gromacs_fep_gpu_tpu_torch.models import solvation, water
    sigma = [water.O_SIGMA, 0.1, solvation.LIG_C_SIGMA,
             solvation.LIG_H_SIGMA, 0.1]
    eps = [water.O_EPS, 0.0, solvation.LIG_C_EPS, solvation.LIG_H_EPS, 0.0]
    nbfp = lj_table_from_sigma_eps(sigma, eps, comb_rule=2)
    for k in (1, 4):
        nbfp[k, :, :] = 0.0
        nbfp[:, k, :] = 0.0
    return build_system([(solvation.methane_like_ligand(True), 1),
                         (water.tip3p_moltype(), n_side ** 3 - 1)], nbfp,
                        device=device)


def _charmm_params(**kw):
    """_base_params with the GROMACS manual's CHARMM non-bonded settings:
    vdwtype cut-off with force-switch, rvdw 1.2, rvdw-switch 1.0, PME with
    rcoulomb 1.2, DispCorr no (rlist from the Verlet buffer)."""
    from gromacs_fep_gpu_tpu_torch.core.types import VdwModifier
    return _params(mts=True).replace(
        rcoulomb=CHARMM_RC, rvdw=CHARMM_RC, rlist=CHARMM_RC,
        vdw_modifier=VdwModifier.FORCE_SWITCH, rvdw_switch=CHARMM_RSW,
        dispcorr=False, **kw)


def _pairs_in_cut(planes, box, prep, r2max, block=64):
    """Unique pairs of the pack's list (K7a: the union row of the
    i-cluster's supercluster) that take the pair math: both atoms real and
    unperturbed, not the self pair, r^2 below the larger cut-off
    (rectangular minimum image).  The full list holds each twice."""
    from gromacs_fep_gpu_tpu_torch.ops.pairlist import CLUSTER
    dev = planes[0].device
    bl = torch.diagonal(box)
    ar = torch.arange(CLUSTER, device=dev)
    n = 0
    for c0 in range(0, prep.n_icl, block):
        ci = torch.arange(c0, min(c0 + block, prep.n_icl), device=dev)
        B = ci.shape[0]
        row = ci // 8 if prep.layout == "super" else ci
        jid = (prep.nbr[row].long()[..., None] * CLUSTER + ar).reshape(B, -1)
        iid = (prep.i0 + ci)[:, None] * CLUSTER + ar
        r2 = 0.0
        for p, L in zip(planes, bl):
            d = p[iid][..., None] - p[jid][:, None, :]
            d = d - torch.round(d / L) * L
            r2 = r2 + d * d
        ok = ((prep.pv[iid][..., None] > 0) & (prep.pv[jid][:, None, :] > 0)
              & (iid[..., None] != jid[:, None, :]) & (r2 < r2max))
        n += int(ok.sum())
    return n // 2


def _cluster_bytes(prep, flavour):
    """Compulsory bytes of one launch: every input read once (the planes,
    the live list entries and counts, exclusions or shifts and lane masks,
    the LJ table) and every output written once.  On a domain's halo plane
    only the clusters that the live list and the i range address are
    read."""
    n_rows, n_icl = prep.n_rows, prep.n_icl
    live = int(prep.cnt.sum())
    if prep.halo:
        W = prep.nbr.shape[1]
        live_e = torch.arange(W, device=prep.nbr.device)[None, :] \
            < prep.cnt[:, None].to(torch.int64)
        n_rows = 8 * int(torch.unique(torch.cat([
            prep.nbr[live_e].to(torch.int64),
            torch.arange(prep.i0, prep.i0 + n_icl,
                         device=prep.nbr.device)])).numel())
    per_atom = 5 + (1 if prep.nbfp is not None else 2)
    b = per_atom * 4 * n_rows + 4 * (live + prep.cnt.numel()) + 36
    if prep.nbfp is not None:
        b += prep.nbfp.numel() * 4
    if prep.layout == "v2":
        b += live * (3 + 8) * 4
    else:
        b += prep.excl.numel() * 4
    ne = 5 if flavour == "VFV" else 2
    return b + 3 * 4 * n_icl * 8 + ne * 4 * n_icl


def _cluster_kernel_rows(runner, state, timer, flavours, n_pairs=None):
    """The per-cluster kernel of runner's layout in each flavour against
    its plain version on one frame.  Gates: forces rel 5e-4 of max |F|,
    energies rel 1e-4, the virial Xi_aa = -1/4 sum of the per-cluster
    partials (float64 sum) rel 1e-4 of max |Xi_aa|; every call launches
    the kernel exactly once."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import NbConstants
    params, layout = runner.params, runner.layout
    x, box = state.x, state.box
    nlist, _, prep, fl = runner.lists(state)
    consts = NbConstants.from_params(params, get_beta(params))
    planes = nb_cluster.gather_planes(x, box, nlist, prep)
    if n_pairs is None:
        n_pairs = _pairs_in_cut(planes, box, prep,
                                max(consts.rc2, consts.rv2))
    flops = FLOPS_PAIR_TABLE if layout == "table" else FLOPS_PAIR
    R, W = prep.nbr.shape
    rows = []
    for flavour in flavours:
        name = f"nb_{layout}_{flavour}"
        energy, virial = flavour != "F", flavour == "VFV"

        def kern(e=energy, v=virial):
            return nb_cluster.nb_cluster_cuda(planes, box, prep, consts, e,
                                              v)

        def plain(e=energy, v=virial):
            return nb_cluster.nb_cluster_plain(planes, box, prep, consts, e,
                                               v)
        before = nb_cluster.launches[layout][flavour]
        fk = kern()
        if nb_cluster.launches[layout][flavour] != before + 1:
            raise AssertionError(f"{name}: one call, "
                                 f"{nb_cluster.launches[layout][flavour] - before}"
                                 " launches")
        fp = plain()
        torch.cuda.synchronize()
        f_rel, f_abs = _rel(torch.stack(fk[:3], -1), torch.stack(fp[:3], -1))
        e_rel = v_rel = 0.0
        if energy:
            ek, ep = (0.5 * o[3][:, :2].double().sum(0) for o in (fk, fp))
            e_rel = float(((ek - ep).abs() / ep.abs()).max())
        if virial:
            vk, vp = (-0.25 * o[3][:, 2:5].double().sum(0) for o in (fk, fp))
            v_rel, v_abs = _rel(vk, vp)
            f_abs = max(f_abs, v_abs)
        ok = f_rel <= F_REL and e_rel <= E_REL and v_rel <= E_REL
        ms = timer.ms(kern)
        plain_ms = _median_ms(plain, reps=3)
        bound, by = _bound_ms(_cluster_bytes(prep, flavour),
                              n_pairs * (flops + FLOPS_JFORCE
                                         + (9 if virial else 0)))
        _say(f"{name} ({x.shape[0]:,} atoms): {R} rows x {W} entries, "
             f"{int(prep.cnt.sum())} live, unique pairs in cut-off "
             f"{n_pairs}; F "
             f"rel {f_rel:.2e}, E rel {e_rel:.2e}, virial rel {v_rel:.2e} "
             f"-> {'ok' if ok else 'FAIL'}; {ms:.4f} ms (plain "
             f"{plain_ms:.3f} ms, bound {bound:.5f} ms by {by}, library "
             f"none)")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        rows.append(dict(
            name=name, route="cuda",
            source="gromacs_fep_gpu_tpu_torch/csrc/nb_cluster.cu",
            replaces=REPLACES[layout], max_abs_err=f_abs, ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None))
    return rows, n_pairs


def phase_cluster_kernels(system, params, state, timer, caps):
    """Phase 10: K7a/b/c and the table kernel at the main path's shapes,
    then the five NB routes against each other at one state (VF: forces
    rel 5e-4 of max |F|, energies rel 1e-4, against the table kernel).
    Returns the K7 rows (their launches come from phase 13)."""
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster, nb_v2u
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import NbConstants

    def runner(layout):
        return MdRunner(system, params, RunnerConfig(
            layout=layout, super_nnbr=caps[0], fep_max_nbr=caps[1]))
    rows, n_pairs, routes = [], None, {}
    for layout in K7_LAYOUTS + ("table",):
        r = runner(layout)
        out, n_pairs = _cluster_kernel_rows(r, state, timer, ("F", "VF"),
                                            n_pairs)
        # the table kernel's rows come from the CHARMM path, which runs it
        rows += out if layout != "table" else []
        routes[layout] = r
    routes["v2u"] = runner("v2u")
    consts = NbConstants.from_params(params, get_beta(params))
    res = {}
    for layout, r in routes.items():
        nlist, _, prep, _ = r.lists(state)
        fn = (nb_v2u.cluster_forces_v2u if layout == "v2u"
              else nb_cluster.cluster_forces)
        f, ec, el = fn(state.x, state.box, nlist, prep, consts, True)
        res[layout] = (f[nlist.inv_perm], torch.stack([ec, el]).double())
    torch.cuda.synchronize()
    f_ref, e_ref = res["table"]
    worst = 0.0
    for layout, (f, e) in res.items():
        f_rel, _ = _rel(f, f_ref)
        e_rel = float(((e - e_ref).abs() / e_ref.abs()).max())
        worst = max(worst, f_rel / F_REL, e_rel / E_REL)
        _say(f"  NB route {layout:7s} vs the table kernel: F rel "
             f"{f_rel:.2e}, E (coul, lj) {[round(float(v), 3) for v in e]}"
             f" rel {e_rel:.2e}")
    if worst > 1.0:
        raise AssertionError("the NB routes disagree at one state")
    _say(f"five NB routes agree at {state.x.shape[0]:,} atoms "
         f"({n_pairs} unique pairs in the cut-off)")
    return rows


def phase_small_charmm(device):
    """Phase 11: the Lorentz-Berthelot table on the default RunnerConfig
    (demoted to the table route) at 650 atoms, force-switch and then
    potential-switch, rc 0.75 nm and rvdw-switch 0.6 nm (the CHARMM
    cut-offs do not fit a 1.86 nm box), a 5-window ladder at window 2.
    GPU against CPU over 20 steps (the small reference's gates), then the
    GPU's final frame against the dense float64 oracle: the potential
    and the LJ energy rel 1e-4, forces rel 1e-4 of max |F|, Delta H rel
    1e-4 of max |Delta H|."""
    from gromacs_fep_gpu_tpu_torch.core.types import TcouplType, VdwModifier
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, concat_logs
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    from gromacs_fep_gpu_tpu_torch.ops.forces import (dense_energy, get_beta,
                                                      make_dense_force_fn)
    from gromacs_fep_gpu_tpu_torch.ops.pme import pme_grid_size
    from gromacs_fep_gpu_tpu_torch.parallel.ensemble import lambda_schedule
    n_side, window, nsteps = 6, 2, 20
    ladder = lambda_schedule(5)
    for modifier in (VdwModifier.FORCE_SWITCH, VdwModifier.POTENTIAL_SWITCH):
        params = _params(mts=True).replace(
            dt=0.001, rcoulomb=0.75, rvdw=0.75, rlist=0.75, rvdw_switch=0.6,
            vdw_modifier=modifier,
            pme_grid=pme_grid_size((n_side * 0.31,) * 3, 0.12),
            tcoupl=TcouplType.NO, nstcalcenergy=10)
        params = params.replace(fep=dataclasses.replace(params.fep,
                                                        nstdhdl=10))
        out = {}
        for dev in (device, "cpu"):
            system = _lb_system(n_side, dev)
            _, state = solvation_system(n_side=n_side, seed=0, device=dev)
            state = state.replace(lam=torch.tensor(ladder[window],
                                                   device=dev),
                                  fep_state=window)
            runner = MdRunner(system, params, all_lambda=ladder)
            if runner.layout != "table":
                raise AssertionError("the LB table did not demote to the "
                                     "table route")
            state, logs = runner.run(state, nsteps)
            out[dev] = (state, concat_logs(logs), runner)
        (sg, lgg, run_g), (sc, lgc, run_c) = out[device], out["cpu"]
        dx = float((sg.x.cpu() - sc.x).abs().max())
        on = torch.isfinite(lgc.epot)
        scale = float(lgc.epot[on].abs().max())
        de = float((lgg.epot.cpu()[on] - lgc.epot[on]).abs().max())
        dl = float((lgg.dvdl.cpu()[on][:, 2:4] - lgc.dvdl[on][:, 2:4])
                   .abs().max())
        dh_rel, _ = _rel(lgg.delta_h.cpu()[on], lgc.delta_h[on])
        _say(f"small CHARMM-style reference ({modifier.value}, LB table, "
             f"{system.n_atoms} atoms, {nsteps} steps, {run_g.n_regrow} "
             f"regrows to nnbr {run_g.config.nnbr}): GPU vs CPU max|dx| "
             f"{dx:.3e} nm, max|dEpot| {de:.3e}, max|d dvdl| {dl:.3e} "
             f"(scale {scale:.1f}), Delta H rel {dh_rel:.2e}")
        if not (dx <= 2e-4 and de <= 1e-4 * scale and dl <= 1e-4 * scale
                and dh_rel <= E_REL):
            raise AssertionError("small CHARMM-style reference: GPU run "
                                 "disagrees with CPU")
        # the GPU's final frame against the dense float64 oracle
        nlist, feplist, prep, _ = run_g.lists(sg)
        f_k, t_k = run_g._force_fn(sg.x, sg.box, sg.lam, nlist, feplist,
                                   prep)
        dh_k = run_g._foreign(feplist)(sg.x, sg.box, sg.lam)
        x64, box64 = sg.x.cpu().double(), sg.box.cpu().double()
        lam64 = sg.lam.cpu().double()
        f_o, t_o = make_dense_force_fn(run_c.system, params,
                                       run_c.recip_fn)(x64, box64, lam64)
        beta = get_beta(params)
        with torch.no_grad():
            e = [dense_energy(x64, box64, lm, run_c.system, params, beta,
                              run_c.recip_fn).epot
                 for lm in list(torch.tensor(ladder).double()) + [lam64]]
        dh_o = torch.stack(e[:-1]) - e[-1]
        e_rel = abs(float(t_k.epot) - float(t_o.epot)) / abs(
            float(t_o.epot))
        lj_k = float(t_k.lj + t_k.lj14)
        lj_o = float(t_o.lj + t_o.lj14)
        lj_rel = abs(lj_k - lj_o) / abs(lj_o)
        f_rel, _ = _rel(f_k.cpu().double(), f_o)
        o_rel, _ = _rel(dh_k.cpu().double(), dh_o)
        _say(f"  final frame vs dense float64 oracle: Epot "
             f"{float(t_k.epot):.3f} vs {float(t_o.epot):.3f} (rel "
             f"{e_rel:.2e}), LJ {lj_k:.3f} vs {lj_o:.3f} (rel {lj_rel:.2e}),"
             f" F rel {f_rel:.2e}, Delta H rel {o_rel:.2e}")
        if not (e_rel <= E_REL and lj_rel <= E_REL and f_rel <= E_REL
                and o_rel <= E_REL):
            raise AssertionError(f"{modifier.value}: the table route "
                                 "disagrees with the dense oracle")


def phase_charmm(device, timer, smi, start):
    """Phase 12: the CHARMM path at 12,290 atoms from the main path's
    production state.  Returns the table kernel's rows (launches: F and VF
    from the 400 production steps, VF+virial from the C-rescale steps),
    the production state and the grown per-cluster capacity."""
    from gromacs_fep_gpu_tpu_torch.core.types import PcouplType
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    system = _lb_system(N_SIDE, device)
    params = _charmm_params()
    eq = MdRunner(system, params.replace(tau_t=0.1))
    if eq.layout != "table":
        raise AssertionError("the CHARMM path did not demote to the table "
                             "route")
    _say(f"CHARMM path: {system.n_atoms} atoms, LB table, force-switch "
         f"{CHARMM_RSW}-{CHARMM_RC} nm, PME rc {CHARMM_RC} nm, rlist "
         f"{eq._rlist if eq._rlist else 'at first run'}, layout "
         f"{eq.layout}")
    state, lg, sec, counts = _drive(eq, start.replace(step=0),
                                    CHARMM_EQ_STEPS, "CHARMM equilibration")
    _say(f"CHARMM equilibration: {CHARMM_EQ_STEPS} steps in {sec:.2f} s, "
         f"rlist {eq._rlist:.4f} nm, regrows {eq.n_regrow} (nnbr 64 -> "
         f"{eq.config.nnbr}, fep_max_nbr {eq.config.fep_max_nbr}), final T "
         f"{float(lg.temp[-1]):.1f} K")

    prod = MdRunner(system, params)
    rows, _ = _cluster_kernel_rows(prod, state, timer, ("F", "VF", "VFV"))
    prod = MdRunner(system, params)      # the default RunnerConfig again
    state, lg, sec, counts = _drive(prod, state, PROD_STEPS,
                                    "CHARMM production")
    t_lo, t_hi = float(lg.temp.min()), float(lg.temp.max())
    on = torch.isfinite(lg.epot)
    ms_step = sec / PROD_STEPS * 1e3
    ns_day = PROD_STEPS * params.dt / 1000.0 / sec * 86400.0
    nb = {k: v for k, v in counts.items() if k.startswith("nb_") and v}
    _say(f"CHARMM production (MTS2, dt 2 fs, table route): {PROD_STEPS} "
         f"steps, {ms_step:.3f} ms/step, {ns_day:.2f} ns/day on {smi}; NB "
         f"launches {nb}; regrows {prod.n_regrow} (nnbr 64 -> "
         f"{prod.config.nnbr}); flags {prod.last_flags}; T {t_lo:.1f}.."
         f"{t_hi:.1f} K; Epot {[round(float(e), 1) for e in lg.epot[on]]}; "
         f"dV/dl coul {[round(float(d), 2) for d in lg.dvdl[on][:, 2]]} vdw "
         f"{[round(float(d), 2) for d in lg.dvdl[on][:, 3]]}")
    if set(nb) - {"nb_table_F", "nb_table_VF"}:
        raise AssertionError(f"CHARMM path: NB launches outside the table "
                             f"kernel: {nb}")
    if not (TEMP_BAND[0] <= t_lo and t_hi <= TEMP_BAND[1]):
        raise AssertionError(f"CHARMM path: temperature left {TEMP_BAND} "
                             f"K: {t_lo:.1f}..{t_hi:.1f}")
    idle = _profile_window(prod, state, params.nstlist, ms_step, top=6)
    _say(f"CHARMM production idle share {idle:.3f} on {smi}")
    for r in rows:
        r["launches"] = counts[r["name"]]

    npt = MdRunner(system, params.replace(
        pcoupl=PcouplType.C_RESCALE, tau_p=1.0, compressibility=4.5e-5,
        nstpcouple=10), RunnerConfig(nnbr=prod.config.nnbr,
                                     fep_max_nbr=prod.config.fep_max_nbr))
    prod_state = state
    state, lg, sec, counts = _drive(npt, state.replace(step=0),
                                    CHARMM_NPT_STEPS, "CHARMM C-rescale")
    p_on = lg.pres[torch.isfinite(lg.pres)]
    _say(f"CHARMM C-rescale on the table route: {CHARMM_NPT_STEPS} steps, "
         f"{sec / CHARMM_NPT_STEPS * 1e3:.3f} ms/step, launches "
         f"{ {k: v for k, v in counts.items() if k.startswith('nb_') and v} }"
         f"; mean P {float(p_on.mean()):.1f} bar over {p_on.numel()} "
         f"pressure steps")
    if counts["nb_table_VFV"] != CHARMM_NPT_STEPS // 10 \
            or not bool(torch.isfinite(p_on).all()):
        raise AssertionError("CHARMM C-rescale: virial flavour launches or "
                             "pressure")
    rows[2]["launches"] = counts["nb_table_VFV"]
    return rows, prod_state, prod.config.nnbr


def phase_layouts(system, params, state, caps):
    """Phase 13: LAYOUT_STEPS steps of the main path on each K7 layout from
    its production state; returns each layout's launches."""
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    total = {}
    for layout in K7_LAYOUTS:
        runner = MdRunner(system, params, RunnerConfig(
            layout=layout, super_nnbr=caps[0], fep_max_nbr=caps[1],
            seed=3))
        _, lg, sec, counts = _drive(runner, state.replace(step=0),
                                    LAYOUT_STEPS, f"layout {layout}")
        nb = {k: v for k, v in counts.items() if k.startswith("nb_") and v}
        _say(f"layout {layout}: {LAYOUT_STEPS} steps, "
             f"{sec / LAYOUT_STEPS * 1e3:.3f} ms/step, NB launches {nb}, "
             f"regrows {runner.n_regrow} (nnbr {runner.config.nnbr}, "
             f"super_nnbr {runner.config.super_nnbr}), T "
             f"{float(lg.temp.min()):.1f}..{float(lg.temp.max()):.1f} K")
        total.update(nb)
    return total


def _dd_mesh(spread=False):
    """Eight domains: all on the first card, or spread round-robin over
    every card (make_mesh's devices=None)."""
    from gromacs_fep_gpu_tpu_torch.parallel.mesh import make_mesh
    if spread:
        return make_mesh(n_spatial=8)
    return make_mesh(n_spatial=8, devices=[torch.device("cuda", 0)] * 8)


def _dd_runner(system, params, mesh, **kw):
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    return MdRunner(system, params, RunnerConfig(
        mesh=mesh, dd_grid=DD_GRID, dd_block=DD_BLOCK, **kw))


def _dd_kernel_rows(runner, state, timer, what):
    """The DD runner's NB kernel (K6 on the v2u layout, the table kernel's
    i-range elsewhere) in F and VF against its plain version on each
    domain of one frame (F rel 5e-4 of max |F| over all domains, E rel
    1e-4 of the summed energies); every call launches once per domain.
    Times and bounds are per launch (a domain's share: the eight launches
    timed together, divided by eight)."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster, nb_v2u
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    from gromacs_fep_gpu_tpu_torch.parallel.spatial import sort_state_arrays
    params = runner.params
    x, box = state.x, state.box
    nlist, _, pack, fl = runner.lists(state)
    consts = nb_v2u.NbConstants.from_params(params, get_beta(params))
    nb = runner._dd_override
    k6 = runner.layout == "v2u"
    if k6:
        cats = nb.planes(x, box, nlist, pack)
        i_off = nb.halo.own_blk * pack.ps
        doms = pack.domains
    else:
        cats = pack.planes(sort_state_arrays(x, nlist, pack.c_pad))
        doms = pack.packs
    nsh = len(cats)
    boxes = [box.to(c.device) for c in cats]
    n_pairs, n_bytes = 0, 0
    if k6:
        bit = torch.arange(32, device=x.device,
                           dtype=torch.int32).reshape(1, -1, 1)
        bl = torch.diagonal(box)
        for cat, dom in zip(cats, doms):
            ip, jp = nb_v2u.gather_cat(cat, i_off, box, dom)
            S, G = dom.nbr2.shape[:2]
            ixyz = [p.reshape(S, -1, 1) for p in ip]
            for g in range(G):
                pair = ((dom.pair_m[:, g, None, :] >> bit) & 1).bool() \
                    & (g < dom.ng)[:, None, None]
                d = [ixyz[a] - jp[a][:, g, None, :] for a in range(3)]
                if dom.shift is None:
                    d = [d[a] - torch.round(d[a] / bl[a]) * bl[a]
                         for a in range(3)]
                r2 = sum(da * da for da in d)
                n_pairs += int((pair & (r2 < consts.rc2)).sum())
            live_g = torch.arange(G, device=x.device)[None, :] \
                < dom.ng[:, None].to(torch.int64)
            live = int(live_g.sum())
            # cat clusters the kernel reads: the live groups' j ids and the
            # own block's i clusters, 8 atoms x 3 coordinates each
            n_cat = int(torch.unique(torch.cat([
                dom.nbr2[live_g].reshape(-1).to(torch.int64),
                torch.arange(i_off, i_off + S * nb_v2u.BU,
                             device=x.device)])).numel())
            # i q, sqrt c6/c12, the live groups' static streams (q, sqrt
            # c6/c12, two masks) and cat ids (and shifts), the cat
            # coordinates read, ng, the outputs
            n_bytes += (3 * S * 32 + 5 * live * 256 + live * 32
                        + n_cat * 24 + S + 3 * S * 32 + 2 * S) * 4 + 36 \
                + (3 * live * 32 if dom.shift is not None else 0)
        n_pairs //= 2
        flops = FLOPS_PAIR
    else:
        for cat, dom in zip(cats, doms):
            n_pairs += _pairs_in_cut(list(cat), box, dom,
                                     max(consts.rc2, consts.rv2))
        flops = FLOPS_PAIR_TABLE
    rows = []
    for flavour in ("F", "VF"):
        energy = flavour == "VF"
        if k6:
            name, key, counter = (f"nb_v2u_DD_{flavour}", f"DD_{flavour}",
                                  nb_v2u.launches)

            def kern(e=energy):
                return [nb_v2u.nb_v2u_dd_cuda(c, i_off, b, d, consts, e)
                        for c, b, d in zip(cats, boxes, doms)]

            def plain(e=energy):
                return [nb_v2u.nb_v2u_dd_plain(c, i_off, b, d, consts, e)
                        for c, b, d in zip(cats, boxes, doms)]
        else:
            name, key, counter = (f"nb_table_dd_{flavour}", flavour,
                                  nb_cluster.launches["table_dd"])

            def kern(e=energy):
                return [nb_cluster.nb_cluster_cuda(list(c), b, d, consts, e)
                        for c, b, d in zip(cats, boxes, doms)]

            def plain(e=energy):
                return [nb_cluster.nb_cluster_plain(list(c), b, d, consts, e)
                        for c, b, d in zip(cats, boxes, doms)]
        before = counter[key]
        out_k = kern()
        if counter[key] != before + nsh:
            raise AssertionError(f"{name}: {counter[key] - before} launches "
                                 f"for {nsh} domains")
        out_p = plain()
        torch.cuda.synchronize()
        f_k = torch.cat([torch.stack([o[0].reshape(-1), o[1].reshape(-1),
                                      o[2].reshape(-1)], -1) for o in out_k])
        f_p = torch.cat([torch.stack([o[0].reshape(-1), o[1].reshape(-1),
                                      o[2].reshape(-1)], -1) for o in out_p])
        f_rel, f_abs = _rel(f_k, f_p)
        e_rel = 0.0
        if energy:
            ek, ep = (0.5 * sum(o[3][:, :2].double().sum(0) for o in out)
                      for out in (out_k, out_p))
            e_rel = float(((ek - ep).abs() / ep.abs()).max())
        ok = f_rel <= F_REL and e_rel <= E_REL
        ms = timer.ms(kern, reps=max(REPS // nsh, 4)) / nsh
        plain_ms = _median_ms(plain, reps=3) / nsh
        if k6:
            b_bytes = n_bytes
        else:
            b_bytes = sum(_cluster_bytes(d, flavour) for d in doms)
        bound, by = _bound_ms(b_bytes / nsh,
                              n_pairs * (flops + FLOPS_JFORCE) / nsh)
        _say(f"{name} ({what}, {x.shape[0]:,} atoms, "
             f"{runner.mesh.placement()}): unique pairs in cut-off "
             f"{n_pairs}; F rel {f_rel:.2e}, E rel {e_rel:.2e} -> "
             f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms per domain launch "
             f"(plain {plain_ms:.3f} ms, bound {bound:.5f} ms by {by}, "
             f"library none)")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        rows.append(dict(
            name=name, route="cuda",
            source=("gromacs_fep_gpu_tpu_torch/csrc/nb_v2u.cu" if k6 else
                    "gromacs_fep_gpu_tpu_torch/csrc/nb_cluster.cu"),
            replaces=REPLACES["k6" if k6 else "table_dd"],
            max_abs_err=f_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None))
    return rows


def _dd_force_check(single, dd, state, what):
    """The whole force (non-bonded, PME, FEP and bonded terms) of the DD
    runner against the single-domain runner's at one state: Epot rel 1e-4,
    F rel 5e-4 of max |F|, dV/dlambda rel 1e-4 of max |dV/dlambda|."""
    out = []
    for r in (single, dd):
        nlist, feplist, prep, _ = r.lists(state)
        f, terms = r._force_fn(state.x, state.box, state.lam, nlist,
                               feplist, prep, need_energy=True)
        out.append((f.double(), terms))
    (f1, t1), (f2, t2) = out
    e_rel = abs(float(t2.epot) - float(t1.epot)) / abs(float(t1.epot))
    f_rel, _ = _rel(f2, f1)
    d_rel, _ = _rel(t2.dvdl.double(), t1.dvdl.double())
    ok = e_rel <= E_REL and f_rel <= F_REL and d_rel <= E_REL
    _say(f"DD force vs single-domain ({what}, {dd.mesh.placement()}): "
         f"Epot {float(t2.epot):.2f} vs {float(t1.epot):.2f} (rel "
         f"{e_rel:.2e}), F rel {f_rel:.2e}, dV/dl rel {d_rel:.2e} (coul "
         f"{float(t2.dvdl[2]):.3f}, vdw {float(t2.dvdl[3]):.3f}) -> "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the DD force disagrees with the "
                             "single-domain force")


def phase_dd(system, params, state, caps, timer, smi, ms_single):
    """Phase 14, the main path under DD (and the CHARMM path's table
    kernel on the halo: phase_dd_charmm).  Returns the K6 rows."""
    mesh = _dd_mesh()
    _say(f"DD: grid {DD_GRID}, dd_block {DD_BLOCK}, "
         f"{mesh.placement()} ({torch.cuda.device_count()} visible)")
    kw = dict(super_nnbr=caps[0], fep_max_nbr=caps[1], seed=5)
    dd = _dd_runner(system, params, mesh, **kw)
    rows = _dd_kernel_rows(dd, state, timer, "main path")
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    single = MdRunner(system, params, RunnerConfig(**kw))
    _dd_force_check(single, dd, state, "main path, production state")
    if torch.cuda.device_count() > 1:
        _dd_force_check(single, _dd_runner(system, params, _dd_mesh(True),
                                           **kw),
                        state, "main path, domains over every card")
    st, lg, sec, counts = _drive(dd, state.replace(step=0), DD_STEPS,
                                 "main path under DD")
    ms_step = sec / DD_STEPS * 1e3
    ns_day = DD_STEPS * params.dt / 1000.0 / sec * 86400.0
    on = torch.isfinite(lg.epot)
    _say(f"main path under DD (MTS2, dt 2 fs): {DD_STEPS} steps, "
         f"{ms_step:.3f} ms/step, {ns_day:.2f} ns/day against "
         f"{ms_single:.3f} ms/step on one domain, on {smi}; launches "
         f"{ {k: v for k, v in counts.items() if v} }; regrows "
         f"{dd.n_regrow} (super_nnbr {dd.config.super_nnbr}, baked shifts "
         f"{dd.config.baked_shifts}); T {float(lg.temp.min()):.1f}.."
         f"{float(lg.temp.max()):.1f} K; Epot "
         f"{[round(float(e), 1) for e in lg.epot[on]]}")
    for r in rows:
        r["launches"] = counts[r["name"]]
    return rows


def phase_dd_charmm(device, start, nnbr, timer, smi):
    """Phase 14, second half: the CHARMM path (Lorentz-Berthelot table,
    force-switch) under DD runs the table kernel on each domain's
    i-cluster range of its halo-extended plane.  Returns its rows."""
    system = _lb_system(N_SIDE, device)
    params = _charmm_params()
    dd = _dd_runner(system, params, _dd_mesh(), nnbr=nnbr, seed=6)
    if dd.layout != "table":
        raise AssertionError("the CHARMM path under DD is not on the table "
                             "route")
    rows = _dd_kernel_rows(dd, start, timer, "CHARMM path")
    st, lg, sec, counts = _drive(dd, start.replace(step=0),
                                 DD_CHARMM_STEPS, "CHARMM path under DD")
    _say(f"CHARMM path under DD: {DD_CHARMM_STEPS} steps, "
         f"{sec / DD_CHARMM_STEPS * 1e3:.3f} ms/step on {smi}; launches "
         f"{ {k: v for k, v in counts.items() if v} }; nnbr "
         f"{dd.config.nnbr}")
    for r in rows:
        r["launches"] = counts[r["name"]]
    return rows


def phase_dd_big(device, smi):
    """Phase 15: 81,002 atoms, single-domain and DD, from the lattice
    start with the equilibration parameters."""
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    system, state = solvation_system(n_side=N_SIDE_BIG, seed=0,
                                     device=device)
    state = _decoupled(state)
    params = _params(mts=False, n_side=N_SIDE_BIG).replace(
        dt=0.0005, tau_t=0.1, nsttcouple=1)
    _say(f"81k system: {system.n_atoms} atoms, box "
         f"{float(state.box[0, 0]):.2f} nm, PME grid {params.pme_grid}")
    kw = dict(super_nnbr=448, fep_max_nbr=512, seed=8)
    single = MdRunner(system, params, RunnerConfig(**kw))
    dd = _dd_runner(system, params, _dd_mesh(), **kw)
    _dd_force_check(single, dd, state, f"{system.n_atoms:,} atoms, lattice "
                    "start")
    out = {}
    for name, r in (("single-domain", single), ("DD", dd)):
        st, lg, sec, counts = _drive(r, state, BIG_STEPS,
                                     f"{system.n_atoms:,} atoms, {name}")
        on = torch.isfinite(lg.epot)
        out[name] = sec / BIG_STEPS * 1e3
        _say(f"{system.n_atoms:,} atoms, {name}: {BIG_STEPS} steps (dt 0.5 "
             f"fs), {out[name]:.3f} ms/step on {smi}; regrows {r.n_regrow} "
             f"(super_nnbr {r.config.super_nnbr}, baked shifts "
             f"{r.config.baked_shifts}); flags {r.last_flags}; Epot "
             f"{[round(float(e), 1) for e in lg.epot[on]]}; T "
             f"{float(lg.temp[-1]):.1f} K; NB launches "
             f"{ {k: v for k, v in counts.items() if k.startswith('nb_') and v} }")
    return out


def run(device="cuda", smi=None):
    """All phases on `device`; returns the kernel rows."""
    import gromacs_fep_gpu_tpu_torch  # noqa: F401  (sets TF32 off)
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system

    smi = smi or _smi()
    _say(f"gpu: {smi}")
    _say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    def done(what):
        _say(f"-- {what} done at {time.perf_counter() - t_start:.1f} s")
    phase_build()
    timer = DeviceTimer()

    phase_small_reference(device)
    done("small reference")

    system, state = solvation_system(n_side=N_SIDE, seed=0, device=device)
    state = _decoupled(state)
    _say(f"system: {system.n_atoms} atoms, box {float(state.box[0, 0]):.2f}"
         f" nm, PME grid {_params(True).pme_grid}")
    eq_params = _params(mts=False).replace(dt=0.0005, tau_t=0.1,
                                           nsttcouple=1)
    eq = MdRunner(system, eq_params, RunnerConfig(super_nnbr=448,
                                                  fep_max_nbr=512))
    state, lg, sec, counts = _drive(eq, state, EQ_STEPS, "equilibration")
    _say(f"equilibration: {EQ_STEPS} steps in {sec:.2f} s, launches "
         f"{counts}, regrows {eq.n_regrow}; T every 50 steps "
         f"{[round(float(v), 1) for v in lg.temp[::50]]} K, final "
         f"{float(lg.temp[-1]):.1f} K")
    done("main path equilibration")

    params = _params(mts=True)
    prod = MdRunner(system, params, RunnerConfig(
        super_nnbr=eq.config.super_nnbr, fep_max_nbr=eq.config.fep_max_nbr,
        seed=1))
    rows = phase_kernels(prod, state, timer)
    cluster_rows = phase_cluster_kernels(
        system, params, state, timer,
        (eq.config.super_nnbr, eq.config.fep_max_nbr))

    state, lg, sec, counts = _drive(prod, state, PROD_STEPS, "production")
    temp = lg.temp
    t_lo, t_hi = float(temp.min()), float(temp.max())
    on = torch.isfinite(lg.epot)
    ms_step = sec / PROD_STEPS * 1e3
    ns_day = PROD_STEPS * params.dt / 1000.0 / sec * 86400.0
    _say(f"production (MTS2, dt 2 fs): {PROD_STEPS} steps, {ms_step:.3f} "
         f"ms/step, {ns_day:.2f} ns/day on {smi}; launches {counts}; "
         f"regrows {prod.n_regrow}; T {t_lo:.1f}..{t_hi:.1f} K, every 50 "
         f"steps {[round(float(v), 1) for v in temp[::50]]}; Epot "
         f"{[round(float(e), 1) for e in lg.epot[on]]}; dV/dl coul "
         f"{[round(float(d), 2) for d in lg.dvdl[on][:, 2]]} vdw "
         f"{[round(float(d), 2) for d in lg.dvdl[on][:, 3]]}")
    if not (TEMP_BAND[0] <= t_lo and t_hi <= TEMP_BAND[1]):
        raise AssertionError(f"temperature left {TEMP_BAND} K: "
                             f"{t_lo:.1f}..{t_hi:.1f}")
    for r in rows:
        r["launches"] = counts[r["name"]]
    phase_profile(prod, state, 2 * params.nstlist, ms_step)
    done("main path kernels, production and profile")

    caps = (prod.config.super_nnbr, prod.config.fep_max_nbr)
    layout_counts = phase_layouts(system, params, state, caps)
    for r in cluster_rows:
        r["launches"] = layout_counts.get(r["name"], 0)
    done("K7 layouts")
    dd_rows = phase_dd(system, params, state, caps, timer, smi, ms_step)
    done("main path under DD")
    phase_small_charmm(device)
    table_rows, charmm_state, charmm_nnbr = phase_charmm(device, timer, smi,
                                                         state)
    done("CHARMM path")
    dd_rows += phase_dd_charmm(device, charmm_state, charmm_nnbr, timer,
                               smi)
    done("CHARMM path under DD")
    phase_dd_big(device, smi)
    done("81,002 atoms")

    window_rows, window_counts, npt_start = phase_window(device, timer, smi)
    done("lambda windows")
    npt_rows, npt_counts = phase_npt(timer, smi, *npt_start)
    done("NPT windows")
    for r in rows:
        if r["name"].startswith("nb_v2u"):    # K1 runs on every path
            r["launches_window"] = window_counts[r["name"]]
            r["launches_npt"] = npt_counts[r["name"]]
    rows += cluster_rows + table_rows + dd_rows + window_rows + npt_rows
    for r in rows:
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} never ran on its path")
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    smi = _smi()
    rows = run("cuda", smi)
    _say(smi)
    _say(json.dumps({"kernels": rows}))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
