#!/usr/bin/env python3
"""Take the per-cluster kernel's time apart on one GPU (csrc/nb_cluster.cu,
nb_table_kernel: the table route and its DD i-range, or with --k7 the
K7a/b/c layouts on the same body).

    python3 chip_probe_table.py [--production] [--k7]

At the CHARMM path's 12,290-atom frame (chip_smoke.py's Lorentz-Berthelot
system, force-switch 1.0-1.2 nm, PME rc 1.2; the lattice start, or with
--production the frame after chip_smoke.py's main-path equilibration and
500 CHARMM steps), the kernel is built from the repository's source
together with two variants of that source:
- exact_f: the F flavour with the exact erfcf and expf in place of the
  pmecorrF fit (kFitF false);
- no_cull: every tile kept (the same design without the cull);
- ring16: a sixteen-slot ring per warp (seven pairs of entries in
  flight, not three);
- chunks: each warp walks one contiguous chunk of the row's entries, in
  place of the pairs dealt to the warps in turn;
- max32: up to 32 warps per i-cluster (CTAs of 1,024 threads, one per SM
  at 64 registers), timed at 32 warps.
Each variant is held against the plain version (forces rel 5e-4 of max
|F|, energies rel 1e-4) and timed in F and VF on the whole system and, per
domain launch, on the (2, 2, 2) DD i-range; the repository's kernel is
also timed at every power of two of warps per i-cluster beside the one the
wrapper takes (table_warps).  It prints the tiles the cull keeps
(cull_table_tiles_plain) and the card's name and power limit.

With --k7, at the main path's 12,290-atom frame (the lattice start, or with
--production the frame after chip_smoke.py's main-path equilibration),
each K7 layout (super, cluster, v2; geometric LJ, potential shift, PME rc
0.9) is held against k7_plain and timed in F and VF as built from the
repository's source, from the no_cull variant and from an erfcf variant
(the energy flavours with erfcf in place of the erfc polynomial,
kPolyErfc false), and at every power of two of warps per i-cluster.
Needs one card; exits non-zero without one.
"""
import ctypes
import dataclasses
import subprocess
import sys

import torch

import chip_smoke as cs

FIT_F = "constexpr bool kFitF = true;"
POLY = "constexpr bool kPolyErfc = true;"
SLOTS = "constexpr int kSlots = 8;"
MAX_WARPS = "constexpr int kMaxWarps = 16;"
BOUNDS = "__launch_bounds__(kTableThreads, 2)"
DEAL = """  const int t_end = warp < n_pairs
      ? 2 * ((n_pairs - warp + nwarps - 1) / nwarps) : 0;
  auto ent = [&](int t) { return 2 * (warp + (t >> 1) * nwarps) + (t & 1); };
"""
CHUNKS = """  const int chunk = 2 * ((n_pairs + nwarps - 1) / nwarps);
  const int t_end = (max(0, min(chunk, n - warp * chunk)) + 1) & ~1;
  auto ent = [&](int t) { return warp * chunk + t; };
"""
CULL = "(j_in && !(d2 > a.lim))"
WARPS = (1, 2, 4, 8, 16)


def variants(src):
    """The repository's source and its variants, by name."""
    if any(src.count(k) != 1 for k in (FIT_F, POLY, CULL, SLOTS, MAX_WARPS,
                                        BOUNDS, DEAL)):
        raise AssertionError("csrc/nb_cluster.cu no longer has the kFitF "
                             "or kPolyErfc switch, the cull, kSlots, "
                             "kMaxWarps, the launch bounds or the deal of "
                             "entry pairs this probe edits")
    return {
        "repo": src,
        "exact_f": src.replace(FIT_F, FIT_F.replace("true", "false")),
        # lim >= 0 always holds: every tile is kept, and the compiler
        # cannot drop the test before it
        "no_cull": src.replace(CULL, CULL + " || a.lim >= 0.f"),
        "ring16": src.replace(SLOTS, SLOTS.replace("8", "16")),
        "chunks": src.replace(DEAL, CHUNKS),
        "max32": src.replace(MAX_WARPS, MAX_WARPS.replace("16", "32"))
        .replace(BOUNDS, BOUNDS.replace("2)", "1)")),
        "erfcf": src.replace(POLY, POLY.replace("true", "false")),
    }


def build(texts):
    """Compile each variant like ops/cuda_lib.py does, all at once, into
    the package's build directory; returns the loaded libraries."""
    from gromacs_fep_gpu_tpu_torch.ops import cuda_lib
    out_dir = cuda_lib.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = out_dir / f"nb_cluster_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
             str(out_dir / f"libnb_cluster_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"libnb_cluster_{name}.so"))
        for fn, argtypes in cuda_lib.SIGNATURES["nb_cluster"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def check(name, kern, plain, energy):
    """Kernel against plain version at the gates; raises on a miss."""
    fk, fp = kern(), plain()
    torch.cuda.synchronize()
    ks = fk if isinstance(fk, list) else [fk]
    ps = fp if isinstance(fp, list) else [fp]
    f_rel, _ = cs._rel(torch.cat([torch.stack(o[:3], -1) for o in ks]),
                       torch.cat([torch.stack(o[:3], -1) for o in ps]))
    e_rel = 0.0
    if energy:
        ek, ep = (0.5 * sum(o[3][:, :2].double().sum(0) for o in out)
                  for out in (ks, ps))
        e_rel = float(((ek - ep).abs() / ep.abs()).max())
    if not (f_rel <= cs.F_REL and e_rel <= cs.E_REL):
        raise AssertionError(f"{name}: F rel {f_rel:.2e}, E rel "
                             f"{e_rel:.2e}")
    return f_rel, e_rel


def frame(production):
    """The CHARMM runner and the frame to probe."""
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    device = "cuda"
    system = cs._lb_system(cs.N_SIDE, device)
    params = cs._charmm_params()
    _, state = solvation_system(n_side=cs.N_SIDE, seed=0, device=device)
    state = cs._decoupled(state)
    if production:
        msys, _ = solvation_system(n_side=cs.N_SIDE, seed=0, device=device)
        eq = MdRunner(msys, cs._params(mts=False).replace(
            dt=0.0005, tau_t=0.1, nsttcouple=1),
            RunnerConfig(super_nnbr=448, fep_max_nbr=512))
        state, _, _, _ = cs._drive(eq, state, cs.EQ_STEPS, "equilibration")
        ceq = MdRunner(system, params.replace(tau_t=0.1))
        state, _, _, _ = cs._drive(ceq, state.replace(step=0),
                                   cs.CHARMM_EQ_STEPS,
                                   "CHARMM equilibration")
    return system, params, state


def k7_frame(production):
    """The main path's system, parameters and frame to probe K7 on."""
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    system, state = solvation_system(n_side=cs.N_SIDE, seed=0,
                                     device="cuda")
    state = cs._decoupled(state)
    if production:
        eq = MdRunner(system, cs._params(mts=False).replace(
            dt=0.0005, tau_t=0.1, nsttcouple=1),
            RunnerConfig(super_nnbr=448, fep_max_nbr=512))
        state, _, _, _ = cs._drive(eq, state, cs.EQ_STEPS, "equilibration")
    return system, cs._params(mts=True), state


def k7_main(smi, production, src):
    """The --k7 probe: each K7 layout as built, without the cull, with
    erfcf in VF, and at 1-16 warps per i-cluster."""
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.ops import cuda_lib, nb_cluster
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import NbConstants
    libs = build({k: v for k, v in variants(src).items()
                  if k in ("repo", "no_cull", "erfcf")})
    cs.phase_build()
    timer = cs.DeviceTimer()
    system, params, state = k7_frame(production)
    consts = NbConstants.from_params(params, get_beta(params))
    box = state.box
    what = "production frame" if production else "lattice start"
    for layout in cs.K7_LAYOUTS:
        runner = MdRunner(system, params, RunnerConfig(
            layout=layout, super_nnbr=448, fep_max_nbr=512))
        nlist, _, prep, _ = runner.lists(state)
        planes = nb_cluster.gather_planes(state.x, box, nlist, prep)
        kept, bad = cs._table_kept(planes, box, prep, consts)
        R, W = prep.nbr.shape
        live = int(prep.cnt.sum()) * (8 if layout == "super" else 1)
        print(f"{what}, {layout}: {R} rows x {W}, {live} entries visited, "
              f"longest row {prep.cnt_max}, warps {prep.warps}, tiles kept "
              f"{kept:.4f} (pairs in the cut-off in skipped tiles {bad})",
              flush=True)

        def kern(e, pr=prep):
            return nb_cluster.nb_cluster_cuda(planes, box, pr, consts, e)

        def plain(e):
            return nb_cluster.k7_plain(planes, box, prep, consts, e)
        for name, lib in libs.items():
            cuda_lib._libs["nb_cluster"] = lib
            for e, flav in ((False, "F"), (True, "VF")):
                if name == "erfcf" and not e:
                    continue
                f_rel, e_rel = check(f"{layout} {name} {flav}",
                                     lambda: kern(e), lambda: plain(e), e)
                ms = timer.ms(lambda: kern(e))
                print(f"{layout:7s} {name:8s} {flav:2s}: {ms:.5f} ms (F rel "
                      f"{f_rel:.2e}, E rel {e_rel:.2e})", flush=True)
        cuda_lib._libs["nb_cluster"] = libs["repo"]
        for w in WARPS:
            pw = dataclasses.replace(prep, warps=w)
            check(f"{layout} warps {w}", lambda: kern(False, pw),
                  lambda: plain(False), False)
            ms = timer.ms(lambda: kern(False, pw))
            mark = "  <- table_warps" if w == prep.warps else ""
            print(f"{layout:7s} repo     F  at {w:2d} warps per i-cluster: "
                  f"{ms:.5f} ms{mark}", flush=True)
    print(f"{smi}")
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_probe_table: no CUDA device", file=sys.stderr)
        return 2
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner
    from gromacs_fep_gpu_tpu_torch.ops import cuda_lib, nb_cluster
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import NbConstants
    from gromacs_fep_gpu_tpu_torch.parallel.spatial import sort_state_arrays
    smi = cs._smi()
    print(f"gpu: {smi}", flush=True)
    production = "--production" in sys.argv[1:]
    src = (cuda_lib.SRC_DIR / "nb_cluster.cu").read_text()
    if "--k7" in sys.argv[1:]:
        return k7_main(smi, production, src)
    libs = build({k: v for k, v in variants(src).items() if k != "erfcf"})
    cs.phase_build()
    timer = cs.DeviceTimer()
    system, params, state = frame(production)
    consts = NbConstants.from_params(params, get_beta(params))
    rmax2 = max(consts.rc2, consts.rv2)
    one = MdRunner(system, params)
    nlist, _, prep, _ = one.lists(state)
    planes = nb_cluster.gather_planes(state.x, state.box, nlist, prep)
    dd = cs._dd_runner(system, params, cs._dd_mesh(), seed=6)
    dnl, _, pack, _ = dd.lists(state)
    cats = [list(c) for c in pack.planes(sort_state_arrays(
        state.x, dnl, pack.c_pad))]
    box = state.box

    def kept(pl, pr):
        keep = nb_cluster.cull_table_tiles_plain(pl, box, pr, consts)
        W = pr.nbr.shape[1]
        live = torch.arange(W, device=keep.device)[None, :] \
            < pr.cnt[:, None].to(torch.int64)
        return float(keep[live].float().mean())
    what = "production frame" if production else "lattice start"
    print(f"{what}: whole system {prep.n_icl} i-clusters, longest row "
          f"{prep.cnt_max}, warps {prep.warps}, tiles kept "
          f"{kept(planes, prep):.4f}; DD (2, 2, 2): {pack.packs[0].n_icl} "
          f"i-clusters per domain, warps "
          f"{sorted({p.warps for p in pack.packs})}, tiles kept "
          f"{min(kept(c, p) for c, p in zip(cats, pack.packs)):.4f}-"
          f"{max(kept(c, p) for c, p in zip(cats, pack.packs)):.4f}",
          flush=True)

    def whole(pr, e):
        return nb_cluster.nb_cluster_cuda(planes, box, pr, consts, e)

    def domains(packs, e):
        return [nb_cluster.nb_cluster_cuda(c, box, p, consts, e)
                for c, p in zip(cats, packs)]
    plain = {e: (lambda e=e: nb_cluster.table_plain(planes, box, prep,
                                                    consts, e))
             for e in (False, True)}
    plain_dd = {e: (lambda e=e: [nb_cluster.table_plain(c, box, p, consts,
                                                        e)
                                 for c, p in zip(cats, pack.packs)])
                for e in (False, True)}
    nsh = len(cats)
    for name, lib in libs.items():
        cuda_lib._libs["nb_cluster"] = lib
        for e, flav in ((False, "F"), (True, "VF")):
            f_rel, e_rel = check(f"{name} {flav}",
                                 lambda: whole(prep, e), plain[e], e)
            check(f"{name} DD {flav}", lambda: domains(pack.packs, e),
                  plain_dd[e], e)
            ms = timer.ms(lambda: whole(prep, e))
            ms_dd = timer.ms(lambda: domains(pack.packs, e),
                             reps=max(cs.REPS // nsh, 4)) / nsh
            print(f"{name:8s} {flav:2s}: whole system {ms:.5f} ms, DD "
                  f"i-range {ms_dd:.5f} ms per domain launch (F rel "
                  f"{f_rel:.2e}, E rel {e_rel:.2e})", flush=True)
        if name == "max32":
            nb_cluster.MAX_WARPS = 32
            p1 = dataclasses.replace(prep, warps=32)
            pd = [dataclasses.replace(p, warps=32) for p in pack.packs]
            check("max32 at 32 warps", lambda: domains(pd, False),
                  plain_dd[False], False)
            ms = timer.ms(lambda: whole(p1, False))
            ms_dd = timer.ms(lambda: domains(pd, False),
                             reps=max(cs.REPS // nsh, 4)) / nsh
            print(f"max32    F at 32 warps per i-cluster: whole system "
                  f"{ms:.5f} ms, DD {ms_dd:.5f} ms per domain launch",
                  flush=True)
            nb_cluster.MAX_WARPS = 16
    cuda_lib._libs["nb_cluster"] = libs["repo"]
    for w in WARPS:
        p1 = dataclasses.replace(prep, warps=w)
        pd = [dataclasses.replace(p, warps=w) for p in pack.packs]
        check(f"warps {w}", lambda: whole(p1, False), plain[False], False)
        ms = timer.ms(lambda: whole(p1, False))
        ms_dd = timer.ms(lambda: domains(pd, False),
                         reps=max(cs.REPS // nsh, 4)) / nsh
        mark = "  <- table_warps" if w == prep.warps else ""
        mark_dd = "  <- table_warps (DD)" if w == pack.packs[0].warps else ""
        print(f"repo F at {w:2d} warps per i-cluster: whole system "
              f"{ms:.5f} ms{mark}; DD {ms_dd:.5f} ms per domain launch"
              f"{mark_dd}", flush=True)
    print(f"rmax {rmax2 ** 0.5:.4f} nm; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
