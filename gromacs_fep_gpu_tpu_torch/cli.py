"""Command-line interface of the PyTorch/CUDA port — counterpart of
gromacs_fep_gpu_tpu/cli.py (cmd_grompp, _load_tpz, cmd_mdrun's md path,
cmd_solvate, cmd_bar, cmd_check, main; the `gmx` multiplex analogue,
reference: src/programs/gmx.cpp:49, mdrun flags from
mdrun/legacymdrunoptions.h incl. the fork's -fep).

    python -m gromacs_fep_gpu_tpu_torch grompp -f md.mdp -p topol.top \\
        -c conf.gro -o topol.tpz
    python -m gromacs_fep_gpu_tpu_torch mdrun -s topol.tpz [-deffnm md] \\
        [-nsteps N] [-cpi md.cpt | md.gmx.cpt] [-maxh H] [-fep gpu|cpu|auto]
    python -m gromacs_fep_gpu_tpu_torch solvate -cp solute.gro -box L \\
        -o conf.gro
    python -m gromacs_fep_gpu_tpu_torch bar -f w0.dhdl.xvg w1.dhdl.xvg ... \\
        [-method mbar]
    python -m gromacs_fep_gpu_tpu_torch check -s topol.tpz | md.cpt | md.edr

The device is the GPU: main(argv, device="cuda").  Without one, grompp,
mdrun and check exit with a message before building anything; nothing
falls back to the CPU.  Only a caller that passes device="cpu" (the
tests) runs them there, on the kernels' plain versions.  solvate and bar
are numpy only.

-fep picks the non-bonded route, with the reference fork's spelling: gpu
is K1 (RunnerConfig(layout="v2u"), JAX's use_pallas=True), cpu the table
route's kernel (layout="table", JAX's XLA route), auto the table route on
a triclinic box or a CPU device and K1 otherwise (JAX cli.py:267-280).

A .tpz holds the same keys and values as the JAX package's, so each
package's grompp output runs on the other's mdrun.  The port's .cpt is
its own (io/checkpoint.py); mdrun also writes the GROMACS-format
.gmx.cpt, which both packages read.  Not ported yet, and raising: .tpr
input and output and trr/xtc (ROADMAP item 8), -rerun and -tunepme
(slice 16), -dd (slice 17), the minimizers, normal modes and TPI (the mdp
reader raises on their integrators).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import time
import types

import numpy as np
import torch


def _device(args) -> torch.device:
    """The run's device; a CUDA device without a GPU exits here."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"tpumd {args.cmd}: no CUDA device (torch.cuda.is_available() "
            "is False); this program runs on the GPU and does not fall "
            "back to the CPU")
    return dev


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def fep_layout(fep: str, box, device) -> str:
    """-fep gpu|cpu|auto -> RunnerConfig.layout."""
    if fep == "gpu":
        return "v2u"
    if fep == "cpu":
        return "table"
    b = np.asarray(box, np.float64)
    triclinic = np.abs(b - np.diag(np.diag(b))).max() > 1e-6
    return "table" if triclinic or torch.device(device).type == "cpu" \
        else "v2u"


def cmd_grompp(args):
    from .io.grompp import preprocess_arrays
    from .io.pdbio import read_structure

    if args.o.endswith(".tpr"):
        raise NotImplementedError("grompp -o .tpr: writing GROMACS run "
                                  "input is not ported yet (ROADMAP item "
                                  "8); write a .tpz")
    device = _device(args)
    mdp_text, top_text = _read(args.f), _read(args.p)
    names, resnames, x, v, box = read_structure(args.c)
    ndx_text = _read(args.n) if args.n else ""
    # -r: the position restraints' reference positions (else the -c ones)
    posres_x = read_structure(args.r)[2] if args.r else None
    # validate by building once (every grompp transform)
    pp = preprocess_arrays(mdp_text, top_text, names, resnames, x, v, box,
                           include_dirs=[os.path.dirname(args.p)],
                           couple_moltype_override=args.couple_moltype,
                           ndx_text=ndx_text or None, posres_x=posres_x,
                           device=device)
    extra = {} if posres_x is None else {"posres_x": posres_x}
    with open(args.o, "wb") as f:   # np.savez would append .npz to a path
        np.savez(f, top=top_text, mdp=mdp_text, x=x,
                 v=(v if v is not None else np.zeros_like(x)), box=box,
                 couple_moltype=args.couple_moltype or "",
                 names=names, resnames=resnames, ndx=ndx_text,
                 include_dir=os.path.dirname(os.path.abspath(args.p)),
                 **extra)
    print(f"wrote {args.o} ({pp.system.n_atoms} atoms)")


def _load_tpz(path, device):
    """(Preprocessed, the tpz's arrays) on `device`."""
    from .io.grompp import preprocess_arrays

    data = np.load(path)
    cm = str(data["couple_moltype"]) or None
    inc = [str(data["include_dir"])] if "include_dir" in data.files else []
    ndx = str(data["ndx"]) if "ndx" in data.files else ""
    pp = preprocess_arrays(str(data["mdp"]), str(data["top"]),
                           [str(n) for n in data["names"]],
                           [str(r) for r in data["resnames"]],
                           data["x"], data["v"], data["box"],
                           include_dirs=inc, couple_moltype_override=cm,
                           ndx_text=ndx or None,
                           posres_x=(data["posres_x"]
                                     if "posres_x" in data.files else None),
                           device=device)
    return pp, data


def _restore(args, state, runner, params, device):
    """State from -cpi: the GROMACS-format checkpoint (x, v, box, step,
    lambda, fep_state, the v-rescale integral, the Parrinello-Rahman box
    velocity) or the port's own (every
    field and the generator of the v-rescale and sd draws).  When the run
    input names another lambda state than the checkpoint (a new window
    started from an equilibrated frame), the run input's lambda vector and
    state are kept."""
    from .io.checkpoint import load_checkpoint
    from .io.cptio import is_gmx_cpt, read_gmx_cpt

    lam, fep_state = state.lam, state.fep_state
    if is_gmx_cpt(args.cpi):
        cp = read_gmx_cpt(args.cpi)
        if cp.natoms != state.n_atoms:
            raise SystemExit(f"{args.cpi}: checkpoint has {cp.natoms} "
                             f"atoms, topology {state.n_atoms}")

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        upd = dict(x=t(cp.state["x"]), box=t(cp.state["box"]),
                   step=int(cp.step))
        if cp.get("v") is not None:
            upd["v"] = t(cp.state["v"])
        if cp.get("lambda") is not None and cp.state["lambda"].size == 7:
            upd["lam"] = t(cp.state["lambda"])
        if cp.get("fep_state") is not None:
            upd["fep_state"] = int(cp.state["fep_state"][0])
        if cp.get("therm_integral") is not None:
            upd["coupling"] = dataclasses.replace(
                state.coupling,
                therm_integral=t(cp.state["therm_integral"][0]))
        if cp.get("boxv") is not None:
            upd["coupling"] = dataclasses.replace(
                upd.get("coupling", state.coupling),
                boxv=t(np.asarray(cp.state["boxv"]).reshape(3, 3)))
        state = state.replace(**upd)
        print(f"restarted from GROMACS checkpoint {args.cpi} "
              f"(written by {cp.version_string}, step {cp.step})")
    else:
        state = load_checkpoint(args.cpi, device, runner.generator)
        print(f"restarted from {args.cpi} at step {state.step}")
    if params.fep.enabled and state.fep_state != fep_state:
        print(f"checkpoint at lambda state {state.fep_state}, run input at "
              f"{fep_state}: the run continues from the checkpoint's frame "
              "at the run input's lambda state")
        state = state.replace(lam=lam, fep_state=fep_state)
    return state


def cmd_mdrun(args):
    """The md path; returns (runner, final state)."""
    from .core.types import FepCoupling as FC
    from .core.types import IntegratorType, PcouplType, TcouplType
    from .io.checkpoint import save_checkpoint
    from .io.cptio import write_gmx_cpt
    from .io.edrio import (DHBT_DH, DHBT_DHDL, EdrFrame, EdrWriter, dh_block,
                           dhcoll_block)
    from .io.groio import write_gro
    from .io.logio import MdLogWriter
    from .io.xvgio import write_dhdl_xvg
    from .md.runner import MdRunner, RunnerConfig, concat_logs

    for given, what in (
            (args.s.endswith(".tpr") or args.mdp,
             "-s .tpr / -mdp: reading GROMACS run input (ROADMAP item 8)"),
            (args.rerun, "-rerun (ROADMAP slice 16)"),
            (args.tunepme, "-tunepme (ROADMAP slice 16)"),
            (str(args.dd).strip() not in ("0", "1", ""),
             "-dd (ROADMAP slice 17)")):
        if given:
            raise NotImplementedError(f"mdrun {what} is not ported yet")
    device = _device(args)
    pp, data = _load_tpz(args.s, device)
    system, params, state, all_lambda = (pp.system, pp.params, pp.state,
                                         pp.all_lambda)
    if args.nsteps is not None:
        params = params.replace(nsteps=args.nsteps)
    if params.nsteps <= 0:
        raise ValueError(f"nsteps = {params.nsteps}: mdrun needs nsteps > 0")
    lam_arr = None if all_lambda is None else np.asarray(all_lambda.T)
    seed = params.ld_seed if params.ld_seed >= 0 else 1993
    runner = MdRunner(system, params,
                      RunnerConfig(layout=fep_layout(args.fep, data["box"],
                                                     device),
                                   seed=seed),
                      all_lambda=lam_arr)
    if args.cpi and os.path.exists(args.cpi):
        state = _restore(args, state, runner, params, device)

    # stop handler: SIGTERM/SIGINT and -maxh end the run cleanly at the
    # next verified chunk with every output and the checkpoint written
    # (reference: mdlib/stophandler.h, sighandler.cpp, mdrun -maxh)
    stop_flag = {"stop": False}

    def on_signal(signum, frame):
        print(f"\nreceived signal {signum}: stopping at the next "
              "checkpoint boundary (send again to abort)")
        if stop_flag["stop"]:
            raise KeyboardInterrupt
        stop_flag["stop"] = True

    old_handlers = {}
    for sg in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sg] = signal.signal(sg, on_signal)
        except ValueError:
            pass   # not the main thread
    t0 = time.time()
    t_end = t0 + 0.99 * args.maxh * 3600.0 if args.maxh else None
    step0 = state.step
    try:
        state, logs = runner.run(
            state, params.nsteps,
            stop_condition=lambda: (stop_flag["stop"] or (
                t_end is not None and time.time() > t_end)))
    finally:
        for sg, h in old_handlers.items():
            signal.signal(sg, h)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    log = types.SimpleNamespace(**{k: v.detach().cpu().numpy() for k, v in
                                   vars(concat_logs(logs)).items()})
    if runner.stopped_at is not None:
        print(f"run stopped early at step {state.step} (signal or -maxh); "
              "outputs cover the completed steps")

    deffnm = args.deffnm
    n_done = len(log.epot)
    times = (step0 + np.arange(n_done)) * params.dt
    np.savetxt(f"{deffnm}.ener.csv",
               np.stack([times, log.epot, log.ekin, log.temp, log.pres], 1),
               header="time epot ekin temp pres", comments="# ")
    if all_lambda is not None:
        keep = ~np.isnan(log.delta_h[:, 0])
        # the JAX writer's columns, and dH/drestraint-lambda where the mdp
        # gives restraint-lambdas
        dhdl_comps = (FC.COUL, FC.VDW, FC.BONDED) + (
            (FC.RESTRAINT,) if pp.separate_dvdl[int(FC.RESTRAINT)] else ())
        write_dhdl_xvg(f"{deffnm}.dhdl.xvg", times[keep], log.dvdl[keep],
                       log.delta_h[keep], lam_arr, state.fep_state,
                       components=dhdl_comps, temperature=params.ref_t)
    # binary .edr with per-frame BAR delta-H blocks (gmx energy / gmx bar
    # interop; reference: fileio/enxio.cpp, mdlib/mdebin_bar.cpp)
    etot = log.epot + log.ekin
    nstdhdl = max(int(params.fep.nstdhdl), 1) if params.fep.enabled else 0
    lam_now = state.lam.cpu().numpy()
    comps = [int(FC.COUL), int(FC.VDW)]
    with EdrWriter(f"{deffnm}.edr",
                   ["Potential", "Kinetic En.", "Total Energy",
                    "Temperature", "Pressure"],
                   ["kJ/mol", "kJ/mol", "kJ/mol", "K", "bar"]) as ew:
        for i in range(n_done):
            blocks = []
            if (nstdhdl > 0 and all_lambda is not None
                    and not np.isnan(log.delta_h[i, 0])):
                blocks.append(dhcoll_block(
                    temperature=params.ref_t, start_time=times[i],
                    delta_time=nstdhdl * params.dt, start_lambda=-1.0,
                    lambda_index=state.fep_state,
                    native_lambda_vec=[float(lam_now[c]) for c in comps],
                    lambda_components=comps))
                # the total dH/dlambda; the JAX writer leaves out the
                # restraint component
                dvdl_sum = np.nansum(log.dvdl[i][[int(FC.FEP), int(FC.COUL),
                                                  int(FC.VDW),
                                                  int(FC.BONDED),
                                                  int(FC.RESTRAINT)]])
                blocks.append(dh_block(DHBT_DHDL, [dvdl_sum], derivative=0))
                for w in range(log.delta_h.shape[1]):
                    blocks.append(dh_block(
                        DHBT_DH, [log.delta_h[i, w]],
                        foreign_lambda=[float(lam_arr[w, c])
                                        for c in comps]))
            ew.write_frame(EdrFrame(
                t=float(times[i]), step=step0 + i,
                ener=np.array([log.epot[i], log.ekin[i], etot[i],
                               log.temp[i], log.pres[i]], np.float32),
                blocks=blocks, dt=params.dt))

    save_checkpoint(f"{deffnm}.cpt", state, runner.generator)
    # the GROMACS-format twin (fileio/checkpoint.cpp write_checkpoint_data)
    write_gmx_cpt(
        f"{deffnm}.gmx.cpt", x=state.x.cpu().numpy(),
        v=state.v.cpu().numpy(), box=state.box.cpu().numpy(), lam=lam_now,
        fep_state=state.fep_state, step=state.step,
        t=float(state.step) * params.dt,
        therm_integral=(float(state.coupling.therm_integral)
                        if params.tcoupl == TcouplType.V_RESCALE else None),
        boxv=(state.coupling.boxv.cpu().numpy()
              if params.pcoupl != PcouplType.NO else None),
        # GROMACS's IntegrationAlgorithm: md 0, sd (SD1) 9
        integrator=9 if params.integrator == IntegratorType.SD else 0)
    write_gro(f"{deffnm}.gro", "tpumd output",
              [str(n) for n in data["names"]],
              [str(r) for r in data["resnames"]], state.x.cpu().numpy(),
              state.v.cpu().numpy(), state.box.cpu().numpy())
    ns_day = n_done * params.dt / 1000.0 / max(wall, 1e-9) * 86400.0
    report = runner.wallcycle.report()
    print(report)
    print(f"\nPerformance: {ns_day:10.3f} ns/day  "
          f"{wall / max(n_done, 1) * 1e3:.3f} ms/step  ({wall:.1f} s wall, "
          f"{n_done} steps, {system.n_atoms} atoms)")
    # md.log: setup report + nstlog energy blocks + averages + performance
    # (reference: MDLogger + EnergyOutput, energyoutput.cpp:1288,1340)
    mdlog = MdLogWriter(f"{deffnm}.log", params, system, argv=sys.argv)
    mdlog.write_frames(log, times, params.nstlog, params.dt)
    mdlog.write_performance(report, ns_day, wall, n_done, system.n_atoms)
    mdlog.close()
    return runner, state


def cmd_solvate(args):
    """Fill a box with TIP3P water around a solute
    (reference: gmxpreprocess/solvate.cpp)."""
    from .io.buildtools import solvate
    from .io.groio import write_gro
    from .io.pdbio import read_structure

    if args.cp:
        names, resnames, x, v, box = read_structure(args.cp)
    else:
        names, resnames, x = [], [], np.zeros((0, 3), np.float32)
        if not args.box:
            raise SystemExit("solvate: need -cp solute.gro or -box L")
    if args.box:
        box = np.eye(3, dtype=np.float32) * args.box
    xw, n_w = solvate(x, box, spacing=args.spacing, shell=args.shell,
                      seed=args.seed)
    names_out = list(names) + ["OW", "HW1", "HW2"] * n_w
    res_out = list(resnames) + ["SOL"] * (3 * n_w)
    x_out = np.concatenate([x, xw]) if len(x) else xw
    write_gro(args.o, "solvated by tpumd", names_out, res_out, x_out,
              None, box)
    print(f"solvate: added {n_w} SOL -> {args.o}")
    print(f"add to [ molecules ]:\nSOL {n_w}")


def read_delta_h(path: str):
    """(Delta H (samples, windows), the window's lambda state or None) of
    one window's dhdl.xvg (its subtitle) or .edr (its DHCOLL blocks)."""
    import re

    from .io.edrio import DHBT_DH, ENX_DH, ENX_DHCOLL, read_edr
    from .io.xvgio import read_xvg

    if path.endswith(".edr"):
        # raw delta-H blocks of the binary energy file (gmx bar's edr
        # input path; mdlib/mdebin_bar.cpp layout)
        rows, state = [], None
        for fr in read_edr(path)[2]:
            series = [np.atleast_1d(np.asarray(b.subs[2][1], float))
                      for b in fr.blocks
                      if b.id == ENX_DH and int(b.subs[0][1][0]) == DHBT_DH]
            if series:
                # (n_foreign, nsamples) -> one row per stored sample
                rows.append(np.stack(series, axis=0).T)
            for b in fr.blocks:
                if b.id == ENX_DHCOLL and len(b.subs) > 1:
                    state = int(b.subs[1][1][0])
        return (np.concatenate(rows) if rows else np.zeros((0, 0))), state
    data, legends = read_xvg(path)
    ndvdl = sum(1 for lg in legends if lg.startswith("dH/d"))
    with open(path) as f:
        m = re.search(r'@ subtitle ".* state (\d+)"', f.read())
    return data[:, 1 + ndvdl:], (int(m.group(1)) if m else None)


def cmd_bar(args):
    """Pairwise BAR along the ladder, or all-sample MBAR.  Each file's
    samples belong to the lambda state its file names (the dhdl.xvg
    subtitle, the edr's DHCOLL block), else to its place in -f."""
    from .analysis.bar import bar_profile
    from .analysis.mbar import mbar
    from .core.units import BOLTZ

    read = [read_delta_h(p) for p in args.f]
    dh_rows = [dh for dh, _ in read]
    states = [s for _, s in read]
    if None in states:
        states = list(range(len(args.f)))
    delta_h = np.concatenate(dh_rows)
    lam_idx = np.concatenate([np.full(d.shape[0], s)
                              for d, s in zip(dh_rows, states)])
    if args.method == "mbar":
        # needs every window to log dH to every ladder state
        if delta_h.shape[1] != len(args.f):
            raise SystemExit(
                f"mbar: {len(args.f)} windows but {delta_h.shape[1]} "
                "dH columns (need calc-lambda-neighbors = -1)")
        keep = np.ones(len(lam_idx), bool)
        for s in states:
            w = np.where(lam_idx == s)[0]
            keep[w[:int(args.b * len(w))]] = False
        f, errs = mbar(delta_h[keep], lam_idx[keep], BOLTZ * args.temp)
        print("state      f (kJ/mol)    +/-")
        for i in range(len(f)):
            print(f"{i:3d}   {f[i]:12.3f}   {errs[i]:8.3f}")
        print(f"\ntotal (MBAR)   {f[-1] - f[0]:12.3f}   "
              f"{errs[-1]:8.3f} kJ/mol")
        return f[-1] - f[0], errs[-1]
    legs, total, err = bar_profile(delta_h, lam_idx, args.temp,
                                   skip_frac=args.b)
    print("lambda pair      dG (kJ/mol)    +/-")
    for i, (dg, e) in enumerate(legs):
        print(f"{i:3d} -> {i + 1:<3d}   {dg:12.3f}   {e:8.3f}")
    print(f"\ntotal          {total:12.3f}   {err:8.3f} kJ/mol")
    return total, err


def cmd_check(args):
    """Summary of a run input (.tpz), a checkpoint (the port's .cpt or a
    GROMACS .cpt) or an energy file (.edr)."""
    from .io.cptio import is_gmx_cpt, read_gmx_cpt

    if args.f:
        raise NotImplementedError("check -f: trr/xtc trajectories are not "
                                  "ported yet (ROADMAP item 8)")
    if not args.s:
        raise SystemExit("check: give -s run input, checkpoint or edr")
    if args.s.endswith(".tpr"):
        raise NotImplementedError("check -s .tpr: reading GROMACS run "
                                  "input is not ported yet (ROADMAP item 8)")
    if args.s.endswith(".cpt") and is_gmx_cpt(args.s):
        # gmx dump -cp analogue (reference: checkpoint.cpp list_checkpoint)
        cp = read_gmx_cpt(args.s)
        print(f"GROMACS checkpoint (file version {cp.file_version}, "
              f"written by '{cp.version_string}')")
        print(f"atoms: {cp.natoms}")
        print(f"step: {cp.step}  t: {cp.t:g} ps  "
              f"part: {cp.simulation_part}")
        print(f"state entries: {sorted(cp.state.keys())}")
        if cp.get("lambda") is not None:
            print(f"lambda: {np.asarray(cp.state['lambda'])}")
        return cp
    if args.s.endswith(".cpt"):
        from .io.checkpoint import load_checkpoint
        state = load_checkpoint(args.s, "cpu")
        print(f"checkpoint: {state.n_atoms} atoms, step {state.step}, "
              f"lambda state {state.fep_state}")
        print(f"lambda: {state.lam.numpy()}")
        print(f"box diag: {np.diag(state.box.numpy()).round(4)}")
        return state
    if args.s.endswith(".edr"):
        from .io.edrio import ENX_DH, read_edr
        names, units, frames = read_edr(args.s)
        n_dh = sum(1 for fr in frames if any(b.id == ENX_DH
                                             for b in fr.blocks))
        print(f"energy file: {len(frames)} frames, terms {names}")
        if frames:
            print(f"steps {frames[0].step} .. {frames[-1].step}, "
                  f"{n_dh} frames with delta-H blocks")
        return frames
    pp, _ = _load_tpz(args.s, _device(args))
    system, params = pp.system, pp.params
    print(f"atoms: {system.n_atoms}")
    print(f"types: {system.nbfp.shape[0]}")
    print(f"perturbed atoms: {int(system.perturbed.sum())}")
    print(f"settle waters: {system.settle.atoms.shape[0]}")
    print(f"constraints: {system.lincs.atoms.shape[0]}")
    for name, il in system.bonded.items():
        print(f"{name}: {il.n}")
    print(f"pairs14: {0 if system.pairs14 is None else system.pairs14.n}")
    print(f"integrator: {params.integrator.value}, dt={params.dt}")
    if pp.all_lambda is not None:
        print(f"lambda windows: {pp.all_lambda.shape[1]}")
    return pp


def main(argv=None, device="cuda"):
    """Parse argv and run the command on `device`; returns what the
    command returns (mdrun: (runner, final state))."""
    p = argparse.ArgumentParser(
        prog="tpumd", description="MD engine with GPU-FEP-class free "
        "energy support (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("grompp", help="preprocess top+gro+mdp into a run "
                       "file")
    g.add_argument("-f", required=True, help="mdp file")
    g.add_argument("-p", required=True, help="top file")
    g.add_argument("-c", required=True, help="gro or pdb file")
    g.add_argument("-n", default=None, help="index file (.ndx)")
    g.add_argument("-r", default=None, help="position-restraint reference "
                   "coordinates (default: those of -c)")
    g.add_argument("-o", default="topol.tpz")
    g.add_argument("--couple-moltype", default=None)
    g.set_defaults(fn=cmd_grompp)

    m = sub.add_parser("mdrun", help="run molecular dynamics")
    m.add_argument("-s", required=True, help="tpz run file")
    m.add_argument("-mdp", default=None, help="run parameters of a .tpr "
                   "(not ported yet)")
    m.add_argument("-deffnm", default="md")
    m.add_argument("-nsteps", type=int, default=None)
    m.add_argument("-cpi", default=None, help="checkpoint to restart from "
                   "(the port's .cpt or a GROMACS .cpt)")
    m.add_argument("-rerun", default=None, help="not ported yet")
    m.add_argument("-tunepme", action="store_true", help="not ported yet")
    m.add_argument("-maxh", type=float, default=0.0,
                   help="stop cleanly (checkpoint + outputs) after "
                        "0.99*maxh hours (reference: mdrun -maxh)")
    m.add_argument("-dd", type=str, default="0", help="not ported yet")
    m.add_argument("-fep", choices=["auto", "cpu", "gpu"], default="auto",
                   help="non-bonded route: gpu = K1 (v2u), cpu = the table "
                   "route's kernel, auto = K1 unless the box is triclinic "
                   "or the device the CPU (the reference fork's mdrun -fep)")
    m.set_defaults(fn=cmd_mdrun)

    sv = sub.add_parser("solvate", help="fill a box with water "
                                        "(reference: gmx solvate)")
    sv.add_argument("-cp", default=None, help="solute .gro")
    sv.add_argument("-o", default="solvated.gro")
    sv.add_argument("-box", type=float, default=0.0,
                    help="cubic box edge (nm); overrides the -cp box")
    sv.add_argument("-spacing", type=float, default=0.31)
    sv.add_argument("-shell", type=float, default=0.24,
                    help="min water-O to solute distance (nm)")
    sv.add_argument("-seed", type=int, default=2021)
    sv.set_defaults(fn=cmd_solvate)

    b = sub.add_parser("bar", help="BAR/MBAR free-energy estimate "
                                   "from dhdl/edr files")
    b.add_argument("-f", nargs="+", required=True)
    b.add_argument("-temp", type=float, default=300.0)
    b.add_argument("-b", type=float, default=0.1, help="skip fraction")
    b.add_argument("-method", default="bar", choices=("bar", "mbar"),
                   help="pairwise BAR or all-sample MBAR")
    b.set_defaults(fn=cmd_bar)

    c = sub.add_parser("check", help="inspect run input, checkpoint or "
                       "energy files (reference: gmx check/dump)")
    c.add_argument("-s", default=None, help=".tpz, .cpt or .edr")
    c.add_argument("-f", default=None, help="trajectory (not ported yet)")
    c.set_defaults(fn=cmd_check)

    args = p.parse_args(argv)
    args.device = device
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        sys.exit(f"tpumd error: file not found: {e.filename or e}")
