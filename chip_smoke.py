#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gromacs_fep_gpu_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:

1. print the card's name and power limit; build every CUDA kernel from
   gromacs_fep_gpu_tpu_torch/csrc with nvcc and print the build time;
2. small reference: the port's MdRunner on the GPU (kernels) against the
   same run on the CPU (plain versions) for a 650-atom box;
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
   step, its idle share, the top kernels and host ops).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Without a GPU it exits non-zero and
prints no result.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

N_SIDE = 16
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
FLOPS_SPREAD_ATOM = 72 + 16 + 128
FLOPS_GATHER_ATOM = 90 + 256 + 192
TEMP_BAND = (260.0, 380.0)      # K, every production step


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


def _params(mts):
    """bench.py::_base_params(16, True, mts) of the JAX package."""
    from gromacs_fep_gpu_tpu_torch.core.types import (
        CoulombType, FepParams, MdParams, TcouplType)
    from gromacs_fep_gpu_tpu_torch.ops.pme import pme_grid_size
    box_l = N_SIDE * 0.31
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


def _counts():
    from gromacs_fep_gpu_tpu_torch.ops import nb_v2u, pme_kernels
    return {"nb_v2u_F": nb_v2u.launches["F"],
            "nb_v2u_VF": nb_v2u.launches["VF"],
            "pme_spread": pme_kernels.launches["spread"],
            "pme_gather": pme_kernels.launches["gather"]}


def _zero_counts():
    from gromacs_fep_gpu_tpu_torch.ops import nb_v2u, pme_kernels
    for d in (nb_v2u.launches, pme_kernels.launches):
        for k in d:
            d[k] = 0


def _expected_counts(runner, start_step, nsteps):
    pat = runner._flavor_pattern(start_step, nsteps)
    return {"nb_v2u_F": pat.count("F") + pat.count("f"),
            "nb_v2u_VF": pat.count("E"),
            "pme_spread": nsteps - pat.count("f"),
            "pme_gather": nsteps - pat.count("f")}


def _drive(runner, state, nsteps, what):
    """MdRunner.run with the counters zeroed just before and read just
    after; checks counts, finiteness and overflow flags."""
    from gromacs_fep_gpu_tpu_torch.md.runner import concat_logs
    expected = _expected_counts(runner, state.step, nsteps)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    state, logs = runner.run(state, nsteps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    if counts != expected:
        raise AssertionError(f"{what}: launches {counts}, expected "
                             f"{expected}")
    lg = concat_logs(logs)
    on = torch.isfinite(lg.epot)
    n_on = int(on.sum())
    if n_on != expected["nb_v2u_VF"]:
        raise AssertionError(f"{what}: {n_on} energy steps, expected "
                             f"{expected['nb_v2u_VF']}")
    if n_on and not bool(torch.isfinite(lg.dvdl[on]).all()):
        raise AssertionError(f"{what}: non-finite dV/dlambda")
    if not bool(torch.isfinite(state.x).all() & torch.isfinite(
            state.v).all()):
        raise AssertionError(f"{what}: non-finite coordinates")
    fl = runner.last_flags
    left = {k: fl[k] for k in ("fep_ovf", "s_ovf", "excl_bad", "shift_bad",
                               "t_ovf")}
    if any(left.values()):
        raise AssertionError(f"{what}: list flags after growth {left}")
    return state, lg, seconds, counts


def phase_build():
    from gromacs_fep_gpu_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()
    regs = [ln.strip() for log in cuda_lib.build_logs.values()
            for ln in log.splitlines() if "registers" in ln]
    _say(f"build: {cuda_lib.build_seconds:.2f} s for "
         f"{len(cuda_lib.SOURCES)} sources")
    for ln in regs:
        _say(f"  {ln}")


def phase_small_reference(device):
    """The whole step on the GPU (kernels) against the CPU (plain
    versions): 650 atoms, 40 steps, two rebuilds, MTS2, no thermostat.
    Gates: positions 2e-4 nm; potential energy and dV/dlambda 1e-4 of the
    reciprocal energy's magnitude (a sum of large terms of both signs;
    atomics and summation order differ, and 40 steps amplify that)."""
    from gromacs_fep_gpu_tpu_torch.core.types import TcouplType
    from gromacs_fep_gpu_tpu_torch.md.runner import (MdRunner, RunnerConfig,
                                                     concat_logs)
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    from gromacs_fep_gpu_tpu_torch.ops.pme import pme_grid_size
    n_side = 6
    params = _params(mts=True).replace(
        dt=0.001, rcoulomb=0.6, rvdw=0.6, rlist=0.6,
        pme_grid=pme_grid_size((n_side * 0.31,) * 3, 0.12),
        tcoupl=TcouplType.NO, nstcalcenergy=20)
    params = params.replace(fep=dataclasses.replace(params.fep, nstdhdl=20))
    out = {}
    for dev in (device, "cpu"):
        system, state = solvation_system(n_side=n_side, seed=0, device=dev)
        runner = MdRunner(system, params, RunnerConfig(
            super_nnbr=128, fep_max_nbr=128, baked_shifts=False))
        state, logs = runner.run(_decoupled(state), 40)
        out[dev] = (state, concat_logs(logs))
    (sg, lgg), (sc, lgc) = out[device], out["cpu"]
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


def phase_kernels(runner, state, timer):
    """Each kernel against its plain version at the main path's shapes."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_v2u, pme, pme_kernels
    from gromacs_fep_gpu_tpu_torch.ops.fep import get_beta
    params, system = runner.params, runner.system
    x, box = state.x, state.box
    nlist, _, prep, fl = runner.rebuild(state)
    if fl["shift_bad"]:
        # a box too small for build-time shifts: the runner's own fallback
        runner.config.baked_shifts = False
        nlist, _, prep, fl = runner.rebuild(state)
    if fl["s_ovf"]:
        raise AssertionError(f"kernel phase: list flags {fl}")
    consts = nb_v2u.NbConstants.from_params(params, get_beta(params))
    ip, jp = nb_v2u.gather_coordinates(x, box, nlist, prep)
    S, G = prep.nbr2.shape[:2]
    rows = []

    # K1 work of this pair list: masked pairs inside the cut-off
    n_pairs = 0
    live_groups = int(prep.ng.sum())
    ixyz = [p.reshape(S, -1, 1) for p in ip]
    bit = torch.arange(32, device=x.device, dtype=torch.int32).reshape(1, -1, 1)
    for g in range(G):
        pair = ((prep.pair_m[:, g, None, :] >> bit) & 1).bool() \
            & (g < prep.ng)[:, None, None]
        r2 = sum((ixyz[d] - jp[d][:, g, None, :]) ** 2 for d in range(3))
        n_pairs += int((pair & (r2 < consts.rc2)).sum())
    k1_bytes = (6 * S * 32 + 8 * live_groups * 256 + S) * 4 + 36 \
        + (3 * S * 32 + 2 * S) * 4
    for energy in (False, True):
        name = "nb_v2u_VF" if energy else "nb_v2u_F"

        def kern(e=energy):
            return nb_v2u.nb_v2u_cuda(ip, jp, box, prep, consts, e)

        def plain(e=energy):
            return nb_v2u.nb_v2u_plain(ip, jp, box, prep, consts, e)
        fk, fp = kern(), plain()
        torch.cuda.synchronize()
        f_k = torch.stack(fk[:3], -1)
        f_p = torch.stack(fp[:3], -1)
        f_rel, f_abs = _rel(f_k, f_p)
        e_rel = 0.0
        if energy:
            ek, ep = 0.5 * fk[3].sum(0), 0.5 * fp[3].sum(0)
            e_rel = float(((ek - ep).abs() / ep.abs()).max())
        ok = f_rel <= F_REL and e_rel <= E_REL
        ms = timer.ms(kern)
        plain_ms = _median_ms(plain, reps=3)
        bound, by = _bound_ms(k1_bytes, n_pairs * FLOPS_PAIR)
        _say(f"{name}: S={S} G={G} live groups {live_groups} pairs in "
             f"cut-off {n_pairs}; F rel {f_rel:.2e}, E rel {e_rel:.2e} -> "
             f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms (plain {plain_ms:.3f} "
             f"ms, bound {bound:.4f} ms by {by})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        rows.append(dict(
            name=name, route="cuda",
            source="gromacs_fep_gpu_tpu_torch/csrc/nb_v2u.cu",
            replaces="gromacs_fep_gpu_tpu/ops/pallas_nb.py:1107",
            max_abs_err=f_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None))

    # K2 / K3 on the lambda-mixed charges of the production step
    K = tuple(params.pme_grid)
    lam_c = float(state.lam[2])
    q = ((1.0 - lam_c) * system.charge_a + lam_c * system.charge_b
         ).contiguous()
    n = x.shape[0]
    ng = K[0] * K[1] * K[2]
    g_k = pme_kernels.spread_cuda(x, box, q, K)
    g_p = pme_kernels.spread_plain(x, box, q, K)
    torch.cuda.synchronize()
    s_rel, s_abs = _rel(g_k, g_p)
    ms = timer.ms(lambda: pme_kernels.spread_cuda(x, box, q, K))
    plain_ms = _median_ms(lambda: pme_kernels.spread_plain(x, box, q, K))
    # library yardstick: the index_add_ of the 64 taps, weights given
    _, (i0, i1, i2), (wx, wy, wz), _ = pme_kernels._support(x, box, K)
    flat = ((i0[:, :, None, None] * K[1] + i1[:, None, :, None]) * K[2]
            + i2[:, None, None, :]).reshape(-1)
    val = (q[:, None, None, None] * wx[:, :, None, None]
           * wy[:, None, :, None] * wz[:, None, None, :]).reshape(-1)
    lib_ms = timer.ms(lambda: torch.zeros(ng, device=x.device).index_add_(
        0, flat, val))
    bound, by = _bound_ms(16 * n + 4 * ng + 36, FLOPS_SPREAD_ATOM * n)
    # the kernel's atomics add in an order that changes from run to run:
    # the grid is held at the energy gate, rel 1e-4 of its largest value
    ok = s_rel <= E_REL
    _say(f"pme_spread: n={n} grid {K}; grid rel {s_rel:.2e} -> "
         f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms (plain {plain_ms:.3f} ms, "
         f"index_add_ {lib_ms:.4f} ms, bound {bound:.5f} ms by {by})")
    if not ok:
        raise AssertionError("pme_spread disagrees with its plain version")
    rows.append(dict(
        name="pme_spread", route="cuda",
        source="gromacs_fep_gpu_tpu_torch/csrc/pme_spline.cu",
        replaces="gromacs_fep_gpu_tpu/ops/pme_blocked.py:394",
        max_abs_err=s_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms))

    influence = pme.influence_tensors(
        pme.make_influence_function(K, params.pme_order), x.device)
    _, phi = pme.energy_and_potential(g_p, box, consts.beta, influence)
    o_k = pme_kernels.gather_cuda(x, box, q, phi)
    o_p = pme_kernels.gather_plain(x, box, q, phi)
    torch.cuda.synchronize()
    gf_rel, gf_abs = _rel(o_k[:, :3], o_p[:, :3])
    gq_rel, gq_abs = _rel(o_k[:, 3], o_p[:, 3])
    ms = timer.ms(lambda: pme_kernels.gather_cuda(x, box, q, phi))
    plain_ms = _median_ms(lambda: pme_kernels.gather_plain(x, box, q, phi))
    bound, by = _bound_ms(16 * n + 4 * ng + 36 + 16 * n,
                          FLOPS_GATHER_ATOM * n)
    ok = gf_rel <= F_REL and gq_rel <= E_REL
    _say(f"pme_gather: force rel {gf_rel:.2e}, dE/dq rel {gq_rel:.2e} -> "
         f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms (plain {plain_ms:.3f} ms, "
         f"bound {bound:.5f} ms by {by})")
    if not ok:
        raise AssertionError("pme_gather disagrees with its plain version")
    rows.append(dict(
        name="pme_gather", route="cuda",
        source="gromacs_fep_gpu_tpu_torch/csrc/pme_spline.cu",
        replaces="gromacs_fep_gpu_tpu/ops/pme_blocked.py:447",
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    for e in ev[:10]:
        _say(f"  {e.self_device_time_total / 1e3 / nsteps:9.4f} ms/step "
             f"{e.count / nsteps:6.1f}/step  {e.key[:90]}")
    cpu = sorted((e for e in avg if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)
    _say("  host: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3 / nsteps:.2f} ms/step"
        for e in cpu[:8]))


def run(device="cuda", smi=None):
    """All phases on `device`; returns the kernel rows."""
    import gromacs_fep_gpu_tpu_torch  # noqa: F401  (sets TF32 off)
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system

    smi = smi or _smi()
    _say(f"gpu: {smi}")
    _say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build()
    timer = DeviceTimer()

    phase_small_reference(device)

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

    params = _params(mts=True)
    prod = MdRunner(system, params, RunnerConfig(
        super_nnbr=eq.config.super_nnbr, fep_max_nbr=eq.config.fep_max_nbr,
        seed=1))
    rows = phase_kernels(prod, state, timer)

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
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} never ran on the main path")
    phase_profile(prod, state, 2 * params.nstlist, ms_step)
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
