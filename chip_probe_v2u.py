#!/usr/bin/env python3
"""Take the v2u kernel's time apart on one GPU (K1, csrc/nb_v2u.cu).

    python3 chip_probe_v2u.py [--lattice]

At the 12,290-atom main path's production frame (the equilibration of
chip_smoke.py, 2,000 steps; --lattice: the lattice start), the kernel is
built from the repository's source together with two variants of that
source:
- no_tiles: the tile loop removed, so what remains is the fixed cost of
  each CTA (loading its i atoms, staging the groups, the j boxes, the
  barriers and the outputs);
- no_cull: every tile kept (the same design without the cull).
The repository's kernel and no_cull are held against the plain version
(forces rel 5e-4 of max |F|, energies rel 1e-4); each variant is timed in
F and VF at splits 1 to 10 beside the split that the wrapper takes.  The
card's name and power limit come first.  Needs one card; exits non-zero
without one.
"""
import ctypes
import subprocess
import sys

import torch

import chip_smoke as cs

SPLITS = (1, 2, 3, 4, 5, 6, 8, 10)
TILE_LOOP = "    while (keep) {\n"
CULL = "keep = __ballot_sync(kFull, i_bad || bad || !(d2 > lim));"


def variants(src):
    """The repository's source and the two variants, by name."""
    if src.count(TILE_LOOP) != 1 or src.count(CULL) != 1:
        raise AssertionError("csrc/nb_v2u.cu no longer has the tile loop "
                             "or the cull this probe edits")
    return {
        "repo": src,
        # lim < 0 never holds: the loop runs no tile, and the compiler
        # cannot drop the work before it
        "no_tiles": src.replace(TILE_LOOP,
                                "    if (lim >= 0.f) keep = 0u;\n"
                                + TILE_LOOP),
        "no_cull": src.replace(CULL, CULL.replace(
            "!(d2 > lim)", "!(d2 > lim) || lim >= 0.f")),
    }


def build(texts):
    """Compile each variant like ops/cuda_lib.py does, all at once, into
    the package's build directory; returns the loaded libraries."""
    from gromacs_fep_gpu_tpu_torch.ops import cuda_lib
    out_dir = cuda_lib.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = out_dir / f"nb_v2u_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
             str(out_dir / f"libnb_v2u_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"libnb_v2u_{name}.so"))
        for fn, argtypes in cuda_lib.SIGNATURES["nb_v2u"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print("chip_probe_v2u: no CUDA device", file=sys.stderr)
        return 2
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    from gromacs_fep_gpu_tpu_torch.ops import cuda_lib, nb_v2u
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    smi = cs._smi()
    cs._say(f"gpu: {smi}")
    libs = build(variants((cuda_lib.SRC_DIR / "nb_v2u.cu").read_text()))
    timer = cs.DeviceTimer()
    system, state = solvation_system(n_side=cs.N_SIDE, seed=0,
                                     device="cuda")
    state = cs._decoupled(state)
    caps = (448, 512)
    frame = "lattice start"
    if "--lattice" not in sys.argv:
        eq_params = cs._params(mts=False).replace(dt=0.0005, tau_t=0.1,
                                                  nsttcouple=1)
        eq = MdRunner(system, eq_params, RunnerConfig(
            super_nnbr=caps[0], fep_max_nbr=caps[1]))
        state, _, _, _ = cs._drive(eq, state, cs.EQ_STEPS, "equilibration")
        caps = (eq.config.super_nnbr, eq.config.fep_max_nbr)
        frame = f"production frame ({cs.EQ_STEPS} equilibration steps)"
    params = cs._params(mts=True)
    runner = MdRunner(system, params, RunnerConfig(
        super_nnbr=caps[0], fep_max_nbr=caps[1]))
    nlist, _, prep, _ = runner.lists(state)
    consts = nb_v2u.NbConstants.from_params(params, get_beta(params))
    x, box = state.x, state.box
    plane = nb_v2u.sorted_plane(x, box, nlist, prep)
    ip, jp = nb_v2u.gather_coordinates(x, box, nlist, prep)
    live = torch.arange(prep.nbr2.shape[1], device=x.device)[None, :] \
        < prep.ng[:, None].to(torch.int64)
    cs._say(f"{x.shape[0]:,} atoms, {frame}: S={prep.nbr2.shape[0]} "
            f"G={prep.nbr2.shape[1]} live groups {int(live.sum())}, tiles "
            f"kept {cs._tiles_kept(plane, 0, box, prep, consts):.4f}")
    for energy in (False, True):
        fp = nb_v2u.nb_v2u_plain(ip, jp, box, prep, consts, energy)
        ep = 0.5 * fp[3][:, :2].double().sum(0)
        for name, lib in libs.items():
            cuda_lib._libs["nb_v2u"] = lib
            nb_v2u._ctas_per_sm.clear()
            auto = nb_v2u.launch_split(plane, prep, consts, energy)
            times = []
            for split in SPLITS:
                def kern(s=split):
                    return nb_v2u._launch(plane, 0, box, prep, consts,
                                          energy, False, split=s)
                fk = kern()
                torch.cuda.synchronize()
                if name != "no_tiles":
                    f_rel, _ = cs._rel(torch.stack(fk[:3], -1),
                                       torch.stack(fp[:3], -1))
                    e_rel = 0.0
                    if energy:
                        ek = 0.5 * fk[3][:, :2].double().sum(0)
                        e_rel = float(((ek - ep).abs() / ep.abs()).max())
                    if f_rel > cs.F_REL or e_rel > cs.E_REL:
                        raise AssertionError(f"{name} split {split}: F rel "
                                             f"{f_rel:.2e}, E rel "
                                             f"{e_rel:.2e}")
                times.append(f"{split}: {timer.ms(kern):.5f}")
            cs._say(f"{'VF' if energy else 'F '} {name:8s} (the wrapper's "
                    f"split {auto}) ms by split: " + ", ".join(times))
    cs._say(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
