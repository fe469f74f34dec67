#!/usr/bin/env python3
"""Time the PME gather of two trees of the port on one GPU, in turns.

    python3 chip_probe_gather.py --other DIR

DIR is another checkout of this repository, for example the parent
commit unpacked with `git archive` into a git-ignored directory.  Each
turn is a child process that imports gromacs_fep_gpu_tpu_torch from one
tree, builds its csrc/pme_spline.cu alone, and at three shapes (the main
path's 12,290 atoms on 42^3, the lambda window's 5,186 on 32^3, 81,002 on
80^3; lattice starts of solvation_system, charges at lambda_coul 0.5, a
potential grid made with numpy from a seed) measures:
- the gather kernel alone: CUDA events over REPS launches of gather_cuda,
  behind a sleep kernel that keeps host time outside the events (median
  of 5 batches);
- the whole pme.phi_gather call on the host clock, each call ending in
  torch.cuda.synchronize() (median of REPS calls);
- the device operations of one call: kernels and memcpy/memset under
  torch.profiler over ten calls, and synchronising operations under
  torch.cuda.set_sync_debug_mode("warn").
The turns run other, this, this, other; each tree's two turns are
printed, then the mean of each tree's two, and the forces and dE/dq of
the two trees against each other (max |a - b| / max |b|).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = (("main", 16), ("window", 12), ("big", 30))
REPS = 50
CALLS = 10


def _child(root, out):
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    from gromacs_fep_gpu_tpu_torch.ops import cuda_lib, pme, pme_kernels

    cuda_lib.SOURCES = ("pme_spline.cu",)
    cuda_lib.library("pme_spline")
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = 20_000_000 / a.elapsed_time(b)

    def kernel_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        ms = []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(int(cycles_per_ms * (2.0 * host_ms + 5.0)))
            a.record()
            for _ in range(REPS):
                fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b) / REPS)
        return statistics.median(ms)

    def call_ms(fn):
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    def device_ops(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        copy = sum(e.count for e in ev
                   if e.key.startswith(("Memcpy", "Memset")))
        return (sum(e.count for e in ev) - copy) / CALLS, copy / CALLS

    def syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return sum("called a synchronizing" in str(w.message)
                   for w in caught)

    res, arrays = {}, {}
    for name, n_side in SHAPES:
        system, state = solvation_system(n_side=n_side, seed=0,
                                         device="cuda")
        x, box = state.x, state.box
        q = (0.5 * system.charge_a + 0.5 * system.charge_b).contiguous()
        K = tuple(pme.pme_grid_size((n_side * 0.31,) * 3, 0.12))
        phi = torch.as_tensor(np.random.RandomState(11).normal(size=K)
                              .astype(np.float32), device="cuda")

        def call():
            return pme.phi_gather(x, box, q, phi, K)
        f, d = call()
        arrays[f"{name}_f"] = f.cpu().numpy()
        arrays[f"{name}_d"] = d.cpu().numpy()
        kern, copy = device_ops(call)
        res[name] = dict(
            n=int(x.shape[0]), grid=K,
            kernel_ms=kernel_ms(
                lambda: pme_kernels.gather_cuda(x, box, q, phi)),
            call_ms=call_ms(call), kernels=kern, copies=copy,
            syncs=syncs(call))
    np.savez(out, **arrays)
    print("PROBE " + json.dumps(res), flush=True)


def _turn(root, out):
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", root,
         "--out", out], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"turn on {root} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("PROBE ")][-1]
    return json.loads(line[len("PROBE "):])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="another checkout, timed in turns")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(args.child, args.out)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_probe_gather: no CUDA device", file=sys.stderr)
        return 2
    if not args.other:
        ap.error("--other DIR is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}", flush=True)
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    runs = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, who in enumerate(("other", "this", "this", "other")):
            out = os.path.join(tmp, f"{who}{i}.npz")
            runs[who].append(_turn(trees[who], out))
            print(f"turn {i + 1} ({who}, {trees[who]}): "
                  + json.dumps(runs[who][-1]), flush=True)
        arr = {who: np.load(os.path.join(tmp, f"{who}{i}.npz"))
               for i, who in ((0, "other"), (1, "this"))}
        for name, _ in SHAPES:
            mean = {who: {k: statistics.mean(t[name][k] for t in runs[who])
                          for k in ("kernel_ms", "call_ms", "kernels",
                                    "copies", "syncs")} for who in runs}
            rel = {}
            for part in ("f", "d"):
                a, b = (arr[w][f"{name}_{part}"] for w in ("this", "other"))
                rel[part] = float(np.abs(a - b).max()
                                  / max(np.abs(b).max(), 1e-30))
            print(f"{name} ({runs['this'][0][name]['n']} atoms, grid "
                  f"{tuple(runs['this'][0][name]['grid'])}): kernel "
                  f"{mean['other']['kernel_ms']:.5f} -> "
                  f"{mean['this']['kernel_ms']:.5f} ms; whole phi_gather "
                  f"call {mean['other']['call_ms']:.4f} -> "
                  f"{mean['this']['call_ms']:.4f} ms on the host clock; "
                  f"device kernels per call {mean['other']['kernels']:g} -> "
                  f"{mean['this']['kernels']:g}, memcpy/memset "
                  f"{mean['other']['copies']:g} -> "
                  f"{mean['this']['copies']:g}, syncs "
                  f"{mean['other']['syncs']:g} -> {mean['this']['syncs']:g};"
                  f" this against other: forces rel {rel['f']:.2e}, dE/dq "
                  f"rel {rel['d']:.2e} (other -> this, means of two turns "
                  f"each, on {smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
