#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gromacs_fep_gpu_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:

1. print the card's name and power limit; build every CUDA kernel from
   gromacs_fep_gpu_tpu_torch/csrc with nvcc and print the build time;
   torch.profiler over ten pme.phi_gather calls at each path's shapes
   (12,290, 5,186 and 81,002 atoms): ten gather kernels, no memcpy or
   memset (phase_gather_calls);
2. small reference: the port's MdRunner on the GPU (kernels) against the
   same run on the CPU (plain versions) for a 650-atom box, with a
   5-window lambda ladder: positions, energies, dV/dlambda and the
   foreign-lambda Delta H; then the GPU's Delta H on its final frame
   against the dense O(N^2) oracle in float64;
3. main path, equilibration: the 12,290-atom solvation-FEP system
   (n_side 16, ligand at lambda_coul = lambda_vdw = 0.5), dt 1 fs,
   tau_t 0.1 ps, no MTS, 1,000 steps (1 ps), through MdRunner.run;
4. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (equilibrated state, production pair list), with
   its time, its plain version's time and its bound (the gather also: no
   sync under set_sync_debug_mode("error"), the whole pme.phi_gather
   call's host time, bit-identical repeats); then the spread
   kernel's edge cases (spread_edge_cases: supports that wrap on each
   axis, a triclinic box, 4,096 atoms in one grid cell, n = 1, 17 and 0, a
   non-finite atom of zero charge, a 5-atom perturbed subset) against
   spread_plain, grid rel 1e-4 and NaN exactly where it has NaN; then the
   gather kernel on the same cases (phase_gather_edges, reading edge_phi)
   against gather_plain, forces rel 5e-4 and dE/dq rel 1e-4, NaN in
   exactly its rows, repeats bit-identical, n = 0 launching nothing, and
   neutral atoms gathered (dE/dq as the plain version's, force 0); the
   synchronising operations left in one PME reciprocal force call
   (pme_sync_report, a print); then the v2u kernel's edge cases
   (phase_v2u_edges: a pair placed on its tile's box distance at rc^2
   (1 -+ 1e-6), a NaN atom, the minimum image on a
   small box and at 12,290 atoms, a skewed ng that splits) against
   plane_gather + nb_v2u_plain at the gates, NaN in exactly its rows;
   K1's rows print the tiles that the cull keeps, the split and the
   unsplit time;
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
   for 200 steps each with MTS2 and a Delta H sweep every 100 steps; the
   launch counters must match the flavour pattern, Delta H must be finite
   on exactly the sweep steps and ~0 for the own window; dhdl.xvg is
   written and read back and BAR's estimate of the 10 -> 11 leg printed;
8. K4/K5: spread and phi_gather at that path's shapes against their plain
   versions (the gather as in phase 4, and against the any-order einsum
   body), with time, bound and index_add_ time; the foreign sweep's time
   and launch count;
9. NPT lambda window: from the window path's equilibrated state at window
   10, C-rescale (isotropic, tau_p 1 ps, ref_p 1 bar, compressibility
   4.5e-5 /bar, nstpcouple 10) with the dispersion correction (DispCorr =
   EnerPres): 500 NPT steps, then windows 10 and 11 for 200 steps each
   with a Delta H sweep every 100 steps -> dhdl.xvg -> BAR.  Each pressure
   step runs K1's virial flavour; the launch counters must match the
   flavour pattern exactly, the density stay in 0.90-1.10 g/cm^3 and the
   volume of the windows within 3 % of the equilibrated one.  The step
   and force of a pressure step ('R') are timed beside those of an 'F' and
   an 'E' step.  K1 VF+virial is held against its
   plain version at both paths' shapes (phases 4 and 9), and the small
   reference (phase 2) holds the cluster route's in-force virial on the
   card against the dense float64 oracle's strain gradient.  Then
   Parrinello-Rahman from the state the windows end in: one window of 200
   steps at window 11's lambda (isotropic, tau_p 2 ps, with the sweep;
   launches exact, density in its band, |dV|/V < 3 %, the ratios of the
   box edges constant to 1e-5, its ms/step beside the C-rescale windows'),
   then 100 steps of semiisotropic PR (L_x = L_y to two ulp, the box
   velocity finite);
10. per-cluster kernels at the main path's shapes (phase 4's frame,
   geometric LJ, potential shift, rc 0.9): K7a ("super", union lists of 8
   clusters), K7b ("cluster"), K7c ("v2", baked shifts) and the table
   route's kernel, each in its flavours (K7a/b/c: F, VF and VF+virial)
   against its plain version (E and virial rel 1e-4, F rel 5e-4 of max
   |F|), each launch counted exactly once, with time, bound and plain
   time; then all five NB routes (K1, K7a, K7b, K7c, the table kernel in
   geometric mode) against each other at one state;
11. small CHARMM-style reference: a 650-atom box with the Lorentz-Berthelot
   table (force-switch, then potential-switch; rc 0.75 nm, rvdw-switch
   0.6 nm) on the default RunnerConfig, which demotes to the table route:
   GPU against CPU over 20 steps, then the GPU's final-frame energies,
   forces and Delta H against the dense float64 oracle at rel 1e-4;
12. the CHARMM path at 12,290 atoms: the main path's system with the
   Lorentz-Berthelot table and the GROMACS manual's CHARMM settings
   (force-switch, rvdw 1.2 nm, rvdw-switch 1.0 nm, PME rcoulomb 1.2 nm,
   DispCorr no, constraints = h-bonds: the ligand's four C-H bonds on
   LINCS), from the main path's production state: 250 steps of
   re-equilibration (tau_t 0.1 ps), the table kernel's F, VF and VF+virial
   against its plain version at these shapes (virial 1e-4 of max |Xi_aa|),
   400 production steps on the default RunnerConfig (every NB launch the
   table kernel's, launches as the flavour pattern says, the per-cluster
   capacity grown from 64 with its roll-backs printed, no overflow left,
   idle share under torch.profiler), then 100 C-rescale steps on the same
   route for its virial flavour (with the SETTLE and LINCS virial; density
   in 0.90-1.10 g/cm^3, |dV|/V < 3 %, the LINCS rows within 1e-4 of their
   lengths); then the table kernel's edge cases
   (phase_table_edges) against its plain version in F, VF and VF+virial,
   each launch twice and bit-identical, NaN exactly where the plain
   version has it: the production frame (with the tiles the cull keeps and
   the warps per i-cluster), a pair on its tile's boundary at r^2 =
   rmax^2 (1 -+ 1e-6) in one box image and across the periodic boundary,
   a NaN atom, one row at W entries and the rest at 1 (at 1, 16 and the
   wrapper's warps per i-cluster), empty rows, 64 atom types at 16
   warps, an i-range pack with i0 > 0, and every vdW modifier with every
   Coulomb type in both LJ modes at 650 atoms;
13. each of the layouts "super", "cluster" and "v2" drives 100 steps of
   the main path from its production state, launches checked; then
   K7a/b/c's edge cases (phase_k7_edges) against k7_plain, each launch
   twice and bit-identical, NaN exactly where the plain version has it:
   the main path's frame (tiles kept, warps) and a NaN atom in F, VF and
   VF+virial, a pair on its tile's boundary in one image and across the
   periodic boundary (K7c: across a baked shift), skewed and empty rows in
   F and VF, for K7a a union row holding a j cluster in range of only one
   of its 8 i-clusters, and cut-off, reaction field and PME at 1,538
   atoms; each layout's virial against the table kernel's on the main
   path's frame (rel 1e-4 of max |Xi_aa|); then 20 C-rescale steps of the
   main path per layout (its VF+virial kernel on the 2 pressure steps,
   launches exact);
14. domain decomposition (DD) on a (2, 2, 2) grid of eight domains, all
   on the first card (the placement is printed; with more than one card
   the force check is repeated with the domains spread round-robin over
   them): K6 (the v2u body on each domain's halo-extended plane) in F and
   VF against its plain version at the main path's shapes, per domain;
   the whole DD force (K6 + sharded PME + FEP) against the single-domain
   force at the production state (Epot rel 1e-4, F rel 5e-4 of max |F|,
   dV/dlambda rel 1e-4 of max |dV/dlambda|); 100 MTS2 steps of the main
   path under DD with exact launch counts (K6 8 per step, K2/K3 8 per
   reciprocal step), ms/step and ns/day beside the single-domain figure;
   then the main path under DD's device time and kernels per step
   (torch.profiler over two rebuilds); then the CHARMM path under DD (the
   table route's kernel on each domain's i-cluster range: F and VF
   against its plain version, then 100 steps, launches exact);
15. 81,002 atoms (n_side 30, 9.3 nm box, 80^3 PME grid), first run at that
   size: the gather kernel at this size (as in phase 4), the DD force
   against the single-domain force at the lattice start (the gates of
   14), then 100 steps each of the single-domain and
   the DD runner with the equilibration parameters (dt 0.5 fs, tau_t 0.1
   ps), finite energies, no halo violation, ms/step of both;
16. the CLI (phase_cli): cli.main in-process on the default device, the
   inputs written from Python: examples/solvation_fep.sh as published
   (solvate, 5 x grompp + mdrun at box 1.24 nm, bar and bar -method mbar;
   the table route, as its Lorentz-Berthelot table demands) and its
   window 0 with combination rule 3 on K1's minimum-image flavour; then
   the same topology (rule 3) solvated at 5.0 nm (12,289 atoms, PME 42^3,
   MTS2, pme_mdp) through grompp and mdrun: 1,000 equilibration steps and
   windows 1 and 2 from its .cpt (launches exact, T in TEMP_BAND, no
   overflow, ener.csv/dhdl.xvg/edr/gmx.cpt read back), bar over the 1 -> 2
   leg, -fep gpu against -fep cpu (rel 1e-4), and a 20 + 20 restart
   against 40 steps; the CLI's ms/step beside phase 5's;
17. a user's ligand (phase_ethanol): OPLS-AA ethanol (ETH_TOP: RB
   dihedrals from [ dihedraltypes ], a perturbed dihedral, a dihedral
   restraint, a flat-bottomed position restraint under -DPOSRES) solvated
   at 5.0 nm (~12,300 atoms, PME 42^3, MTS2, constraints = h-bonds: its
   six C-H and O-H bonds on LINCS, dt 2 fs) and decoupled over a 5-state
   ladder of the coul, vdw, bonded and restraint columns under sd, through
   grompp -r and mdrun -fep gpu: 500 equilibration steps, windows 1 and 2
   x 400 steps from its .cpt; each listed term on the card against the
   CPU, the sweep against single e_lambda calls, each window's mean T in
   285-315 K, launches exact, ms/step, ns/day and kernels/step, the LINCS
   rows' largest relative deviation after each run (<= 1e-4), SETTLE +
   LINCS with a perturbed O-HO length on the card against the CPU
   (positions 5e-6 nm, dV/dlambda rel 1e-4) and the constraint layer's
   time and kernels per call, a 20 + 20 sd restart against 40 steps, BAR
   and MBAR over the 1 -> 2 leg.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Without a GPU it exits non-zero and
prints no result.
"""
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

N_SIDE = 16
N_SIDE_WINDOW = 12      # 1,727 waters + the ligand: 5,186 atoms
N_LAMBDA = 20
WINDOWS = (10, 11)
WINDOW_STEPS = 200
NPT_EQ_STEPS = 500
DENSITY_BAND = (0.90, 1.10)     # g/cm^3
MAX_DV = 0.03                   # |V - V0| / V0 over the NPT windows
PR_TAU_P = 2.0                  # ps, Parrinello-Rahman's (production) tau_p
PR_SHAPE_TOL = 1e-5             # drift of the box edges' ratios, PR window
PR_SEMI_STEPS = 100
AMU_PER_NM3_IN_G_PER_CM3 = 1.66053906660e-3
# the equilibrations of the main path, the lambda window and the CLI: 1 ps
# at dt 1 fs (1,000 steps, where 2,000 at 0.5 fs took twice the time):
# the lattice start cools to ~315 K
EQ_STEPS = 1000
EQ_DT = 0.001
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
# atoms per CTA of the spread and gather kernels (csrc/pme_spline.cu
# kAtoms: 16 tap threads per atom in CTAs of 128)
PME_ATOMS_PER_CTA = 8
# the force conversion inside the gather: g_d (6), the closed-form inverse
# of the box (15), the three forces (12)
FLOPS_GATHER_ATOM = 90 + 256 + 192 + 33
TEMP_BAND = (260.0, 380.0)      # K, every production step
# the CHARMM path (GROMACS manual, "Force fields in GROMACS -> CHARMM")
CHARMM_RC, CHARMM_RSW = 1.2, 1.0
CHARMM_EQ_STEPS = 250
CHARMM_NPT_STEPS = 100
LAYOUT_STEPS = 100
K7_NPT_STEPS = 20       # C-rescale steps per K7 layout (2 pressure steps)
# domain decomposition: the grid and block of mdrun -dd 2x2x2, the steps
# of each DD run, and the 81,002-atom system (26,999 waters + the ligand)
DD_GRID = (2, 2, 2)
DD_BLOCK = 8
DD_STEPS = 100
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


# phase 16: the CLI on the card (examples/solvation_fep.sh, then the main
# path's size and physics in mdp form)
EXAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "solvation_fep.sh")
EXAMPLE_BOX = 1.24       # nm, the script's default
EXAMPLE_STEPS = 200      # per window, the script's default NSTEPS
CLI_BOX = 5.0            # nm: ~4,100 waters + the ligand
CLI_EQ_STEPS = EQ_STEPS
CLI_WINDOW_STEPS = 200
CLI_WINDOWS = (1, 2)
CLI_RESTART_STEPS = 20
EM_STEPS = 200           # steep steps on the freshly solvated CLI box
EM_TOL = 1000.0          # kJ/mol/nm
EM_PROFILE_STEPS = 10    # steep steps under torch.profiler (kernels/step)
SETTLE_DEV = 1e-4        # max |r - d| / d of the SETTLE waters after EM
CLI_NSTXOUT = 100        # trr x and v (nstxout = nstvout) in the windows
CLI_NSTXTC = 20          # xtc x (nstxout-compressed) in the windows


# phase 17: a user's OPLS-AA ligand with dihedrals and restraints, under
# sd, through grompp -r -> mdrun -fep gpu -> bar
ETH_BOX = 5.0            # nm: ~4,100 waters + ethanol, PME 42^3
ETH_EQ_STEPS = 500       # 1 ps at dt 2 fs
ETH_EQ_TAU_T = 0.1       # ps: the equilibration's inverse friction
ETH_WINDOW_STEPS = 400
ETH_WINDOWS = (1, 2)
ETH_RESTART_STEPS = 20
ETH_T_MEAN_BAND = (285.0, 315.0)    # K, each window's mean temperature
LINCS_DEV = 1e-4         # max |r - d| / d over the LINCS rows after a run
ETH_OHO_LEN_B = 0.1      # nm: the O-HO row's B length in the LINCS check

# ethanol on the force field's bond lengths and angles (below): C1-C2-O-HO
# trans, both CH groups staggered
ETH_GRO = """ethanol
    9
    1ETH     C1    1   0.799   0.918   0.900
    1ETH    H11    2   0.760   0.867   0.988
    1ETH    H12    3   0.760   1.020   0.900
    1ETH    H13    4   0.760   0.867   0.812
    1ETH     C2    5   0.952   0.918   0.900
    1ETH    H21    6   0.988   0.969   0.811
    1ETH    H22    7   0.988   0.969   0.989
    1ETH      O    8   0.999   0.785   0.900
    1ETH     HO    9   1.093   0.787   0.900
   1.80000   1.80000   1.80000
"""

# OPLS-AA ethanol (Jorgensen, Maxwell & Tirado-Rives 1996; the type,
# bond, angle and Ryckaert-Bellemans lines as GROMACS's oplsaa.ff carries
# them for opls_135/140/154/155/157) in TIP3P water.  The C1-C2-O-HO
# dihedral carries a B state whose C_n are zero (bonded-lambdas), a
# dihedral restraint on it whose centre moves from 165 to 175 degrees and
# whose force constant grows fourfold (restraint-lambdas) and, under
# -DPOSRES, a
# flat-bottomed position restraint holds C1 within 0.1 nm of grompp -r's
# position.
ETH_TOP = """[ defaults ]
1 3 yes 0.5 0.5

[ atomtypes ]
opls_135  CT  6  12.01100  -0.180  A  3.50000e-01  2.76144e-01
opls_140  HC  1   1.00800   0.060  A  2.50000e-01  1.25520e-01
opls_154  OH  8  15.99940  -0.683  A  3.12000e-01  7.11280e-01
opls_155  HO  1   1.00800   0.418  A  0.00000e+00  0.00000e+00
opls_157  CT  6  12.01100   0.145  A  3.50000e-01  2.76144e-01
OW  OW  8  15.99940  -0.834  A  3.15061e-01  6.36386e-01
HW  HW  1   1.00800   0.417  A  0.00000e+00  0.00000e+00

[ bondtypes ]
CT  CT  1  0.15290  224262.4
CT  HC  1  0.10900  284512.0
CT  OH  1  0.14100  267776.0
HO  OH  1  0.09450  462750.4

[ angletypes ]
CT  CT  HC  1  110.700  313.800
HC  CT  HC  1  107.800  276.144
CT  CT  OH  1  109.500  418.400
HC  CT  OH  1  109.500  292.880
CT  OH  HO  1  108.500  460.240

[ dihedraltypes ]
HC  CT  CT  HC  3   0.62760  1.88280  0.00000  -2.51040  0.00000  0.00000
HC  CT  CT  OH  3   0.97905  2.93716  0.00000  -3.91622  0.00000  0.00000
CT  CT  OH  HO  3  -0.44350  3.83255  0.72801  -4.11705  0.00000  0.00000
HC  CT  OH  HO  3   0.94140  2.82420  0.00000  -3.76560  0.00000  0.00000

[ moleculetype ]
ETH 3

[ atoms ]
1 opls_135 1 ETH C1  1 -0.180 12.011
2 opls_140 1 ETH H11 1  0.060  1.008
3 opls_140 1 ETH H12 1  0.060  1.008
4 opls_140 1 ETH H13 1  0.060  1.008
5 opls_157 1 ETH C2  1  0.145 12.011
6 opls_140 1 ETH H21 1  0.060  1.008
7 opls_140 1 ETH H22 1  0.060  1.008
8 opls_154 1 ETH O   1 -0.683 15.9994
9 opls_155 1 ETH HO  1  0.418  1.008

[ bonds ]
1 2 1
1 3 1
1 4 1
1 5 1
5 6 1
5 7 1
5 8 1
8 9 1

[ pairs ]
2 6 1
2 7 1
2 8 1
3 6 1
3 7 1
3 8 1
4 6 1
4 7 1
4 8 1
1 9 1
6 9 1
7 9 1

[ angles ]
2 1 3 1
2 1 4 1
3 1 4 1
2 1 5 1
3 1 5 1
4 1 5 1
1 5 6 1
1 5 7 1
6 5 7 1
1 5 8 1
6 5 8 1
7 5 8 1
5 8 9 1

[ dihedrals ]
2 1 5 6 3
2 1 5 7 3
2 1 5 8 3
3 1 5 6 3
3 1 5 7 3
3 1 5 8 3
4 1 5 6 3
4 1 5 7 3
4 1 5 8 3
1 5 8 9 3 -0.44350 3.83255 0.72801 -4.11705 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0
6 5 8 9 3
7 5 8 9 3

[ dihedral_restraints ]
1 5 8 9 1 165.0 5.0 100.0 175.0 5.0 400.0

#ifdef POSRES
[ position_restraints ]
1 2 1 0.1 1000.0
#endif

[ moleculetype ]
SOL 2

[ atoms ]
1 OW 1 SOL OW  1 -0.834 15.9994
2 HW 1 SOL HW1 1  0.417 1.008
3 HW 1 SOL HW2 1  0.417 1.008

[ settles ]
1 1 0.09572 0.15139

[ exclusions ]
1 2 3
2 3

[ system ]
ethanol in water

[ molecules ]
ETH 1
SOL {nsol}
"""

# sd at tau-t 1 ps, ethanol's six C-H and O-H bonds constrained (LINCS)
# at dt 2 fs, the ligand decoupled over a 5-state ladder of the coul, vdw,
# bonded and restraint columns
ETH_MDP = """integrator = sd
dt = 0.002
nsteps = {nsteps}
nstlist = 10
coulombtype = reaction-field
rcoulomb = 0.55
rvdw = 0.55
rlist = 0.6
tc-grps = System
tau-t = 1.0
ref-t = 300
ld-seed = 2024
gen-vel = yes
gen-temp = 300
gen-seed = 11
define = -DPOSRES
constraints = h-bonds
free-energy = yes
init-lambda-state = {window}
coul-lambdas = 0.0 0.5 1.0 1.0 1.0
vdw-lambdas = 0.0 0.0 0.0 0.5 1.0
bonded-lambdas = 0.0 0.25 0.5 0.75 1.0
restraint-lambdas = 0.0 0.25 0.5 0.75 1.0
couple-moltype = ETH
couple-lambda0 = vdw-q
couple-lambda1 = none
couple-intramol = no
sc-alpha = 0.5
sc-power = 1
sc-sigma = 0.3
nstcalcenergy = 10
nstdhdl = 10
"""
ETH_N_WIN = 5


def example_inputs(path=EXAMPLE):
    """The published example's inputs, from the here-documents of
    examples/solvation_fep.sh: (lig.gro text, topol.top template over
    {nsol}, mdp template over {nsteps} and {window}, the ladder's window
    count)."""
    with open(path) as f:
        text = f.read()
    docs = dict(re.findall(r"cat > (\S+) <<'?EOF'?\n(.*?)\nEOF\n", text,
                           re.S))
    mdp = docs["md$N.mdp"].replace("$NSTEPS", "{nsteps}").replace(
        "$N", "{window}")
    n_win = len(re.search(r'LAMBDAS="([^"]*)"', text).group(1).split())
    return (docs["lig.gro"] + "\n",
            docs["topol.top"].replace("$NSOL", "{nsol}") + "\n", mdp + "\n",
            n_win)


def mdp_with(text, keys):
    """mdp text with each key of `keys` set: its line replaced in place, or
    a new line appended."""
    lines = text.splitlines()
    for k, v in keys.items():
        line = f"{k} = {v}"
        hit = [i for i, ln in enumerate(lines)
               if ln.split("=")[0].strip() == k]
        if hit:
            lines[hit[0]] = line
        else:
            lines.append(line)
    return "\n".join(lines) + "\n"


def geometric_top(top):
    """The example's topology with combination rule 3 (geometric sigma and
    epsilon, as the main path's system): the published rule 2
    (Lorentz-Berthelot) table demotes every NB layout to the table route,
    as the JAX package drops its Pallas kernel."""
    out = top.replace("1 2 yes 0.5 0.8333", "1 3 yes 0.5 0.8333")
    if out == top:
        raise ValueError("the example's [ defaults ] line changed")
    return out


def pme_mdp(mdp):
    """The example's mdp with the main path's physics: PME at rc 0.9 nm,
    fourier-spacing 0.12, nstlist 20, MTS2 on the reciprocal force,
    energies and Delta H every 100 steps (bench.py::_base_params)."""
    return mdp_with(mdp, {
        "coulombtype": "pme", "rcoulomb": 0.9, "rvdw": 0.9, "rlist": 0.9,
        "fourier-spacing": 0.12, "nstlist": 20, "mts": "yes",
        "mts-levels": 2, "mts-level2-forces": "longrange-nonbonded",
        "mts-level2-factor": 2, "nstcalcenergy": 100, "nstdhdl": 100})


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
    pass's grid), and per foreign sweep ('D', 'S') on a system with
    perturbed charges two more spreads (qA of all atoms, dq of the
    perturbed ones) and one more gather.  Under
    domain decomposition the NB kernel and the spread and gather run once
    per domain."""
    pat = runner._flavor_pattern(start_step, nsteps)
    # the sweep's reciprocal slope runs only on perturbed charges
    q_pert = bool((runner.system.charge_a != runner.system.charge_b).any())
    n_d = (pat.count("D") + pat.count("S")) if q_pert else 0
    nsh = 1 if runner.mesh is None else len(runner.mesh.spatial_devices)
    out = dict.fromkeys(_nb_counts(), 0)
    out.update(dict.fromkeys(PME_KEYS, 0))
    nb = _nb_prefix(runner)
    out.update({nb + "F": nsh * (pat.count("F") + pat.count("f")),
                nb + "VF": nsh * (pat.count("E") + pat.count("D"))})
    if runner.params.pme_grid is not None:     # no PME kernels without PME
        sfx = _pme_suffix(runner.params.pme_grid)
        out.update({"pme_spread" + sfx: nsh * (nsteps - pat.count("f"))
                    + 2 * n_d,
                    "pme_gather" + sfx: nsh * (nsteps - pat.count("f"))
                    + n_d})
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
    bytes they spill (ptxas -v); per instantiation of the v2u kernel (K1 and
    K6), its registers and static shared memory."""
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
    coul = {"0": "cutoff", "1": "RF", "2": "PME"}
    fn = None
    for line in cuda_lib.build_logs.get("nb_v2u", "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = re.search(r"nb_v2u_kernelILb(\d)ELi(\d)ELb(\d)ELb(\d)E",
                           m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            e, c, mi, v = fn.groups()
            smem = re.search(r"(\d+) bytes smem", line)
            flav = "VF+virial" if v == "1" else "VF" if e == "1" else "F"
            _say(f"  nb_v2u {flav:9s} {coul[c]:6s} "
                 f"{'minimum image' if mi == '1' else 'baked shifts '}: "
                 f"{m.group(1)} registers, "
                 f"{smem.group(1) if smem else 0} bytes of shared memory")
            fn = None
    # the per-cluster kernel: registers and spills of each of its 90
    # instantiations, one line per layout, flavour and LJ mode; its shared
    # memory is dynamic (table_smem_bytes)
    mods = ("none", "pot-shift", "force-switch", "pot-switch")
    layouts = ("table", "super", "cluster", "v2")
    regs, spills, fn, spill = {}, {}, None, 0
    for line in cuda_lib.build_logs.get("nb_cluster", "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = re.search(r"nb_table_kernelILi(\d)ELi(\d)ELb(\d)ELi(\d)"
                           r"ELi(\d)E", m.group(1))
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            lay, f, lj, c, mod = (int(g) for g in fn.groups())
            regs.setdefault((lay, f, lj), []).append(
                f"{coul[str(c)]}/{mods[mod]} {m.group(1)}")
            spills[(lay, f, lj)] = spills.get((lay, f, lj), 0) + spill
            fn = None
    for (lay, f, lj), r in sorted(regs.items()):
        flav = ("F", "VF", "VF+virial")[f]
        planes = 8 if lay == 3 else 6 if lj else 7
        T, K = (5 if lj else 0), (0 if lay == 3 else 4)
        _say(f"  nb_table {layouts[lay]:7s} {flav:9s} "
             f"{'LJ table ' if lj else 'sqrt c6/c12'}: registers "
             f"{', '.join(r)}; {spills[(lay, f, lj)]} bytes of spills; "
             f"shared memory (dynamic) "
             f"{table_smem_bytes(T, K, 8, planes, f)} B at 8 warps, "
             f"{table_smem_bytes(T, K, 16, planes, f)} B at 16 (T {T}, K "
             f"{K})")


def table_smem_bytes(T, K, warps, planes, flavour):
    """Dynamic shared memory of one per-cluster kernel CTA
    (nb_table_launch): each warp's eight ring slots of `planes` planes (8
    for K7c) and reduction row, the i halves' boxes, the LJ table, the
    i-cluster's exclusion ids."""
    ne = 5 if flavour == 2 else 2
    return (4 * (warps * (8 * planes * 8 + 24 + ne) + 16 + T * T * 2)
            + 4 * 8 * K)


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


def _v2u_bytes(prep, i_off, ne):
    """Compulsory bytes of one v2u launch (K1 or K6) over prep's S blocks:
    the i blocks' q, sqrt c6, sqrt c12; the live groups' q, sqrt c6, sqrt
    c12 and two mask streams, their cluster ids (and shifts); the plane
    clusters that the live groups and the i blocks address (8 atoms x 3
    coordinates each); ng, the box; the outputs (3 force planes, ne floats
    per block)."""
    from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import BU
    S, G = prep.nbr2.shape[:2]
    dev = prep.ng.device
    live_g = torch.arange(G, device=dev)[None, :] \
        < prep.ng[:, None].to(torch.int64)
    live = int(live_g.sum())
    n_cl = int(torch.unique(torch.cat([
        prep.nbr2[live_g].reshape(-1).to(torch.int64),
        torch.arange(i_off, i_off + S * BU, device=dev)])).numel())
    return (3 * S * 32 + 5 * live * 256 + live * 32 + n_cl * 24 + S
            + 3 * S * 32 + ne * S) * 4 + 36 \
        + (3 * live * 32 if prep.shift is not None else 0)


def _tiles_kept(plane, i_off, box, prep, consts):
    """Share of the live groups' (4 i x 8 j) tiles that the kernel's cull
    keeps (cull_tiles_plain, its plain mirror)."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_v2u
    keep = nb_v2u.cull_tiles_plain(plane, i_off, box, prep, consts)
    G = prep.nbr2.shape[1]
    live = torch.arange(G, device=keep.device)[None, :] \
        < prep.ng[:, None].to(torch.int64)
    return float(keep[live].float().mean())


def _k1_kernel_rows(runner, state, timer, flavours):
    """K1 in each flavour ('F', 'VF', 'VFV') against its plain version on
    one frame of `runner`'s path: the kernel reads the sorted plane
    (sorted_plane), the plain version the gathered i and j planes
    (gather_coordinates).  Gates: forces rel 5e-4, energies rel 1e-4, the
    virial Xi_aa = -1/4 sum of the per-block partials (float64 sum) rel
    1e-4 of max |Xi_aa|; one call, one launch.  The unsplit launch
    (split 1) is held to the same gates and timed beside the wrapper's
    split."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_v2u
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    params = runner.params
    x, box = state.x, state.box
    nlist, _, prep, fl = runner.lists(state)
    consts = nb_v2u.NbConstants.from_params(params, get_beta(params))
    plane = nb_v2u.sorted_plane(x, box, nlist, prep)
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
    kept = _tiles_kept(plane, 0, box, prep, consts)
    # the count of a kernel that reads 8 pre-gathered (S, G, 256) streams
    # per live group, beside this one's (5 streams, the ids, plane rows)
    gathered_bytes = (6 * S * 32 + 8 * live_groups * 256 + S) * 4 + 36 \
        + (3 * S * 32 + 2 * S) * 4
    for flavour in flavours:
        name = "nb_v2u_" + flavour
        energy, virial = flavour != "F", flavour == "VFV"
        split = nb_v2u.launch_split(plane, prep, consts, energy, virial)

        def kern(e=energy, v=virial):
            return nb_v2u.nb_v2u_cuda(plane, box, prep, consts, e, v)

        def unsplit(e=energy, v=virial):
            return nb_v2u._launch(plane, 0, box, prep, consts, e, v, split=1)

        def plain(e=energy, v=virial):
            return nb_v2u.nb_v2u_plain(ip, jp, box, prep, consts, e, v)
        before = nb_v2u.launches[flavour]
        fk = kern()
        if nb_v2u.launches[flavour] != before + 1:
            raise AssertionError(f"{name}: one call, "
                                 f"{nb_v2u.launches[flavour] - before} "
                                 "launches")
        fu, fp = unsplit(), plain()
        torch.cuda.synchronize()
        f_p = torch.stack(fp[:3], -1)
        f_rel, f_abs = _rel(torch.stack(fk[:3], -1), f_p)
        u_rel, _ = _rel(torch.stack(fu[:3], -1), f_p)
        f_rel = max(f_rel, u_rel)
        e_rel = v_rel = 0.0
        if energy:
            ep = 0.5 * fp[3][:, :2].double().sum(0)
            for o in (fk, fu):
                ek = 0.5 * o[3][:, :2].double().sum(0)
                e_rel = max(e_rel, float(((ek - ep).abs() / ep.abs()).max()))
        if virial:
            vp = -0.25 * fp[3][:, 2:5].double().sum(0)
            for o in (fk, fu):
                rel, v_abs = _rel(-0.25 * o[3][:, 2:5].double().sum(0), vp)
                v_rel = max(v_rel, rel)
                f_abs = max(f_abs, v_abs)
        ok = f_rel <= F_REL and e_rel <= E_REL and v_rel <= E_REL
        ms = timer.ms(kern)
        ms_unsplit = timer.ms(unsplit)
        plain_ms = _median_ms(plain, reps=3)
        ne = 5 if virial else 2
        bound, by = _bound_ms(_v2u_bytes(prep, 0, ne),
                              n_pairs * (FLOPS_PAIR + FLOPS_JFORCE
                                         + (9 if virial else 0)))
        gathered_bound, _ = _bound_ms(gathered_bytes + (12 * S if virial else 0), 0)
        _say(f"{name} ({x.shape[0]:,} atoms): S={S} G={G} live "
             f"groups {live_groups} unique pairs in cut-off {n_pairs}; "
             f"tiles kept {kept:.4f}; split {split}; F rel "
             f"{f_rel:.2e}, E rel {e_rel:.2e}, virial rel {v_rel:.2e} -> "
             f"{'ok' if ok else 'FAIL'}; {ms:.5f} ms (unsplit "
             f"{ms_unsplit:.5f} ms; plain {plain_ms:.3f} ms, bound "
             f"{bound:.5f} ms by {by}; pre-gathered j byte count "
             f"{gathered_bytes + (12 * S if virial else 0)} B -> "
             f"{gathered_bound:.5f} ms, now {_v2u_bytes(prep, 0, ne)} B)")
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
    12,290-atom path, the spread wrapper against spread_plain.
    small=True: K4/K5 of the window path, the spread through
    _spread_dispatch, the entry point that stands for the small-system TPU
    kernel.  The gather goes through pme.phi_gather at both (_gather_row),
    at small=True also against the any-order einsum body."""
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
    ctas = -(-n // PME_ATOMS_PER_CTA)
    _say(f"pme_spread{sfx}: n={n} ({int((q == 0).sum())} neutral) grid {K}, "
         f"{ctas} CTAs; grid rel {s_rel:.2e} -> "
         f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms, of which the grid's "
         f"memset {memset_ms:.4f} ms (share {memset_ms / ms:.2f}) (plain "
         f"{plain_ms:.3f} ms, index_add_ {lib_ms:.4f} ms, bound "
         f"{bound:.5f} ms by {by})")
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
    rows.append(_gather_row(
        "pme_gather" + sfx, x, box, q, phi, K, timer,
        ("gromacs_fep_gpu_tpu/ops/pme_pallas.py:170" if small
         else "gromacs_fep_gpu_tpu/ops/pme_blocked.py:447"), einsum=small))
    return rows


def _host_call_ms(fn, reps=REPS):
    """Median host time of one call of fn ending in synchronize()."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _device_ops(fn, calls):
    """torch.profiler over `calls` calls of fn: (kernels, memcpy and memset
    operations, the kernels' names) on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def is_copy(e):
        return e.key.startswith(("Memcpy", "Memset"))
    return (sum(e.count for e in ev if not is_copy(e)),
            sum(e.count for e in ev if is_copy(e)),
            sorted({e.key for e in ev if not is_copy(e)}))


def phase_gather_calls():
    """The whole pme.phi_gather call at the three paths' shapes (lattice
    starts of 12,290, 5,186 and 81,002 atoms, edge_phi): torch.profiler
    over ten calls must see ten gather kernels and no memcpy or memset.
    It runs first, while the process has profiled nothing else: on the
    H100 with torch 2.11, each long profiled window (20 steps of the main
    path) left a later short window with fewer of its device events, until
    none were seen, with or without idle time around the calls.  Even the
    first windows drop an event now and then (9 kernels seen in 10 calls
    on the H100), so a window that sees fewer kernels than calls is
    profiled once more; more kernels, or a copy, fail at once."""
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    from gromacs_fep_gpu_tpu_torch.ops import pme
    for n_side in (N_SIDE, N_SIDE_WINDOW, N_SIDE_BIG):
        system, state = solvation_system(n_side=n_side, seed=0,
                                         device="cuda")
        K = tuple(_params(True, n_side).pme_grid)
        q = (0.5 * system.charge_a + 0.5 * system.charge_b).contiguous()
        phi = torch.as_tensor(edge_phi(K), device="cuda")
        for _ in range(2):
            n_kern, n_copy, names = _device_ops(
                lambda: pme.phi_gather(state.x, state.box, q, phi, K), 10)
            if n_kern >= 10 or n_copy:
                break
            _say(f"pme.phi_gather at {system.n_atoms:,} atoms: the profiler "
                 f"saw {n_kern} kernels in 10 calls; profiling again")
        ok = (n_kern == 10 and n_copy == 0
              and all("pme_gather_kernel" in k for k in names))
        _say(f"pme.phi_gather at {system.n_atoms:,} atoms, grid {K}: "
             f"{n_kern} kernels and {n_copy} memcpy/memset in 10 calls "
             f"(torch.profiler), {names} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("a phi_gather call is not one kernel "
                                 "launch without copies")


def _gather_row(name, x, box, q, phi, K, timer, replaces, einsum=False):
    """The gather kernel at one path's shapes: the entry point
    pme.phi_gather (one launch) and a second launch bit-identical, forces
    at F_REL and dE/dq at E_REL of their largest against gather_plain (with
    einsum, also against the any-order einsum body); the kernel alone
    (CUDA events), the whole phi_gather call on the host clock ending in
    synchronize() and one call under set_sync_debug_mode("error") (its
    device operations: phase_gather_calls).  Returns the kernel row."""
    from gromacs_fep_gpu_tpu_torch.ops import pme, pme_kernels
    n = x.shape[0]

    def call():
        return pme.phi_gather(x, box, q, phi, K)
    before = pme_kernels.launches["gather", K]
    f_k, d_k = call()
    if pme_kernels.launches["gather", K] != before + 1:
        raise AssertionError(f"{name}: phi_gather did not launch the "
                             "gather kernel once")
    f_2, d_2 = pme_kernels.gather_cuda(x, box, q, phi)
    f_p, d_p = pme_kernels.gather_plain(x, box, q, phi)
    torch.cuda.synchronize()
    same = _bits_equal(f_k, f_2) and _bits_equal(d_k, d_2)
    gf_rel, gf_abs = _rel(f_k, f_p)
    gq_rel, gq_abs = _rel(d_k, d_p)
    ok = same and gf_rel <= F_REL and gq_rel <= E_REL
    more = ""
    if einsum:
        f_e, d_e = pme.phi_gather_plain(x, box, q, phi, K, 4)
        ef, _ = _rel(f_k, f_e)
        eq, _ = _rel(d_k, d_e)
        ok = ok and ef <= F_REL and eq <= E_REL
        more = f"; against the einsum body force rel {ef:.2e}, dE/dq {eq:.2e}"
    ms = timer.ms(lambda: pme_kernels.gather_cuda(x, box, q, phi))
    call_ms = _host_call_ms(call)
    plain_ms = _median_ms(lambda: pme_kernels.gather_plain(x, box, q, phi))
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    bound, by = _bound_ms(32 * n + 4 * K[0] * K[1] * K[2] + 36,
                          FLOPS_GATHER_ATOM * n)
    _say(f"{name}: n={n} grid {K}, {-(-n // PME_ATOMS_PER_CTA)} CTAs; "
         f"force rel {gf_rel:.2e}, dE/dq rel {gq_rel:.2e}{more}; repeat "
         f"{'bit-identical' if same else 'DIFFERS'}; no sync under sync "
         f"debug -> {'ok' if ok else 'FAIL'}; kernel {ms:.5f} ms, "
         f"whole phi_gather call {call_ms:.4f} ms on the host clock (plain "
         f"{plain_ms:.3f} ms, bound {bound:.6f} ms by {by})")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return dict(
        name=name, route="cuda",
        source="gromacs_fep_gpu_tpu_torch/csrc/pme_spline.cu",
        replaces=replaces, max_abs_err=max(gf_abs, gq_abs), ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        call_ms=call_ms)


def spread_edge_cases(seed=7):
    """The spread kernel's edge cases, made with numpy from `seed`: a list
    of (name, x (n, 3), box (3, 3), q (n,), grid) in float32, on the main
    path's box and grid unless named otherwise.
    - wrap_x, wrap_y, wrap_z: 96 atoms whose grid coordinate on that axis
      lies in [0, 1) (the support wraps below cell 0) or in [K - 1, K),
      and 4 on the faces (0, L, a hair below 0 where u rounds to K, a hair
      below L);
    - triclinic: 2,000 atoms in and around a lower-triangular box on a
      (40, 36, 45) grid;
    - crowd: 4,096 atoms inside one grid cell (every tap contends);
    - n1, n17, n0: one atom, 17 atoms (a tail CTA), no atom;
    - nonfinite_q0: 300 atoms, one with a NaN coordinate and q = 0;
    - perturbed5: the foreign sweep's energy-only E[dq] spread, 5 atoms of
      one molecule (within ~0.1 nm) with charge differences as charges."""
    rng = np.random.RandomState(seed)
    L = np.float32(N_SIDE * 0.31)
    from gromacs_fep_gpu_tpu_torch.ops.pme import pme_grid_size
    K = tuple(pme_grid_size((float(L),) * 3, 0.12))
    cubic = np.eye(3, dtype=np.float32) * L

    def charges(n):
        return rng.uniform(-1.0, 1.0, n).astype(np.float32)

    def uniform(n):
        return rng.uniform(0.0, L, (n, 3)).astype(np.float32)
    cases = []
    for d, axis in enumerate("xyz"):
        x = uniform(100)
        u = np.concatenate([rng.uniform(0.0, 1.0, 48),
                            rng.uniform(K[d] - 1.0, K[d], 48)])
        x[:96, d] = u / K[d] * L
        x[96:, d] = [0.0, L, -1e-7, L * (1 - 1e-7)]
        cases.append((f"wrap_{axis}", x, cubic, charges(100), K))
    tri = np.array([[L, 0, 0], [0.3 * L, 0.9 * L, 0],
                    [-0.25 * L, 0.2 * L, 0.85 * L]], np.float32)
    s = rng.uniform(-0.5, 1.5, (2000, 3)).astype(np.float32)
    cases.append(("triclinic", (s @ tri).astype(np.float32), tri,
                  charges(2000), (40, 36, 45)))
    cell = np.array([20, 11, 33])
    u = cell + rng.uniform(0.0, 1.0, (4096, 3))
    cases.append(("crowd", (u / np.array(K) * L).astype(np.float32), cubic,
                  charges(4096), K))
    for n in (1, 17, 0):
        cases.append((f"n{n}", uniform(n), cubic, charges(n), K))
    x, q = uniform(300), charges(300)
    x[7, 1], q[7] = np.nan, 0.0
    cases.append(("nonfinite_q0", x, cubic, q, K))
    c = rng.uniform(0.0, L, 3)
    x = (c + rng.normal(0.0, 0.06, (5, 3))).astype(np.float32)
    cases.append(("perturbed5", x, cubic,
                  rng.uniform(-0.8, 0.8, 5).astype(np.float32), K))
    return cases


def edge_phi(grid, seed=11):
    """The potential grid that the gather's edge cases read, made with
    numpy from `seed`."""
    return np.random.RandomState(seed).normal(size=grid).astype(np.float32)


def phase_spread_edges(timer):
    """The spread kernel against spread_plain on each of spread_edge_cases:
    NaN in exactly the cells where the plain grid has NaN, the other cells
    at rel 1e-4 of the largest (the atomics add in an order that changes
    from run to run); n = 0 launches nothing and leaves the grid zero.
    Then the cost of contention (the crowd's time) and of neutral atoms
    (2,000 atoms of zero charge against the same atoms charged)."""
    from gromacs_fep_gpu_tpu_torch.ops import pme_kernels
    t0 = time.perf_counter()
    cases = spread_edge_cases()
    by_name = {c[0]: c[1:] for c in cases}

    def on_card(name):
        x, box, q, K = by_name[name]
        return (*(torch.as_tensor(a, device="cuda") for a in (x, box, q)),
                K)
    for name, *_ in cases:
        x, box, q, K = on_card(name)
        g_k = pme_kernels.spread_cuda(x, box, q, K)
        g_p = pme_kernels.spread_plain(x, box, q, K)
        torch.cuda.synchronize()
        nan_k, nan_p = torch.isnan(g_k), torch.isnan(g_p)
        same_nan = torch.equal(nan_k, nan_p)
        if x.shape[0] == 0:
            ok, rel = bool((g_k == 0).all()) and same_nan, 0.0
        else:
            rel, _ = _rel(g_k[~nan_p], g_p[~nan_p])
            ok = same_nan and rel <= E_REL
        _say(f"spread edge {name}: n={x.shape[0]} grid {K}, "
             f"{-(-x.shape[0] // PME_ATOMS_PER_CTA)} CTAs; grid rel "
             f"{rel:.2e}, NaN cells {int(nan_k.sum())} (plain "
             f"{int(nan_p.sum())}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"spread edge case {name}: the kernel "
                                 "disagrees with spread_plain")
    x, box, q, K = on_card("crowd")
    crowd_ms = timer.ms(lambda: pme_kernels.spread_cuda(x, box, q, K))
    x, box, q, K = on_card("triclinic")
    q0 = torch.zeros_like(q)
    charged_ms = timer.ms(lambda: pme_kernels.spread_cuda(x, box, q, K))
    neutral_ms = timer.ms(lambda: pme_kernels.spread_cuda(x, box, q0, K))
    _say(f"spread edge timings: crowd (4,096 atoms in one cell) "
         f"{crowd_ms:.4f} ms; triclinic 2,000 atoms {charged_ms:.4f} ms "
         f"charged, {neutral_ms:.4f} ms all neutral (skipped after the "
         f"barrier); the edge phase took {time.perf_counter() - t0:.1f} s")


def phase_gather_edges(timer):
    """The gather kernel against gather_plain on each of spread_edge_cases,
    reading edge_phi of the case's grid: NaN in exactly the plain
    version's rows (forces and dE/dq), the other rows at F_REL (forces) and
    E_REL (dE/dq) of their largest, a second launch bit-identical; n = 0
    launches nothing.  Then neutral atoms (the triclinic case at q = 0:
    dE/dq as the plain version's, every force exactly 0), and the times of
    the crowd and of the triclinic case."""
    from gromacs_fep_gpu_tpu_torch.ops import pme_kernels
    t0 = time.perf_counter()
    cases = spread_edge_cases()
    by_name = {c[0]: c[1:] for c in cases}

    def on_card(name):
        x, box, q, K = by_name[name]
        return (*(torch.as_tensor(a, device="cuda")
                  for a in (x, box, q, edge_phi(K))), K)

    def check(what, x, box, q, phi, K):
        before = pme_kernels.launches["gather", K]
        f_k, d_k = pme_kernels.gather_cuda(x, box, q, phi)
        f_2, d_2 = pme_kernels.gather_cuda(x, box, q, phi)
        f_p, d_p = pme_kernels.gather_plain(x, box, q, phi)
        torch.cuda.synchronize()
        n = x.shape[0]
        bad = torch.isnan(d_p)
        same_nan = (torch.equal(torch.isnan(d_k), bad)
                    and torch.equal(torch.isnan(f_k).any(1), bad)
                    and bool(torch.isnan(f_k[bad]).all())
                    and torch.equal(torch.isnan(f_p).any(1), bad))
        same = _bits_equal(f_k, f_2) and _bits_equal(d_k, d_2)
        launched = pme_kernels.launches["gather", K] - before
        rel_f = rel_q = 0.0
        if n == 0:
            ok = (launched == 0 and f_k.shape == (0, 3)
                  and d_k.shape == (0,))
        else:
            rel_f, _ = _rel(f_k[~bad], f_p[~bad])
            rel_q, _ = _rel(d_k[~bad], d_p[~bad])
            ok = (launched == 2 and same_nan and same and rel_f <= F_REL
                  and rel_q <= E_REL)
        _say(f"gather edge {what}: n={n} grid {K}, {launched} launches; "
             f"force rel {rel_f:.2e}, dE/dq rel {rel_q:.2e}, NaN rows "
             f"{int(torch.isnan(d_k).sum())} (plain {int(bad.sum())}), "
             f"repeat {'bit-identical' if same else 'DIFFERS'} -> "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"gather edge case {what}: the kernel "
                                 "disagrees with gather_plain")
        return f_k, d_k, d_p
    for name, *_ in cases:
        check(name, *on_card(name))
    x, box, q, phi, K = on_card("triclinic")
    q0 = torch.zeros_like(q)
    f0, d0, d0_p = check("triclinic, all neutral", x, box, q0, phi, K)
    if not (bool((f0 == 0).all()) and bool((d0 != 0).all())):
        raise AssertionError("gather edge: a neutral atom has a force, or "
                             "no dE/dq")
    tri_ms = timer.ms(lambda: pme_kernels.gather_cuda(x, box, q, phi))
    x, box, q, phi, K = on_card("crowd")
    crowd_ms = timer.ms(lambda: pme_kernels.gather_cuda(x, box, q, phi))
    _say(f"gather edge timings: crowd (4,096 atoms in one cell) "
         f"{crowd_ms:.5f} ms; triclinic 2,000 atoms {tri_ms:.5f} ms; the "
         f"edge phase took {time.perf_counter() - t0:.1f} s")


def pme_sync_report(runner, state):
    """One PME reciprocal force call (_recip_force_fn: spread, solve,
    gather, the E[dq] term of the perturbed charges) on the main path's
    frame under torch.cuda.set_sync_debug_mode("warn"): prints each
    synchronising operation left in it, by file and line (a print, not a
    gate)."""
    import collections
    x, box, lam_c = state.x, state.box, state.lam[2]
    runner.recip_force_fn(x, box, lam_c)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            runner.recip_force_fn(x, box, lam_c)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    where = collections.Counter(
        f"{w.filename.rsplit('/', 2)[-2]}/{w.filename.rsplit('/', 1)[-1]}"
        f":{w.lineno}" for w in caught
        if "called a synchronizing" in str(w.message))
    _say(f"PME syncs in one reciprocal force call (main path frame): "
         f"{sum(where.values())}"
         + "".join(f"; {k} x{v}" for k, v in sorted(where.items())))


def place_boundary_pair(plane, box, prep, rmax2, sign, first_block=0,
                        want_shift=None):
    """Move one j cluster of a live tile so that a masked-in pair sits on
    the tile's box distance at r^2 = rmax2 (1 + sign 1e-6): the cluster is
    translated along x until its lowest-x atom B (after the entry's baked
    shift) lies r from the i half-cluster's highest-x atom A, and B takes
    A's y and z, so the box-to-box distance of the tile is the pair's.  The
    tile is the first one from block `first_block` on whose cluster lies
    outside the block, both atoms carry LJ (sqrt c6 > 0) and, with
    want_shift True/False, whose entry has a nonzero/zero shift.  Returns
    (the moved plane, (s, g, h, k, a, b)): block, group, i half, j cluster,
    A's and B's plane rows.  Works on the CPU (the search reads the list
    there) and returns the plane on its own device."""
    from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import BU, GJU
    cpu = torch.device("cpu")
    p = plane.to(cpu)
    nbr2, sh = prep.nbr2.to(cpu), prep.shift.to(cpu)
    pm, ng = prep.pair_m.to(cpu), prep.ng.to(cpu)
    is6, js6 = prep.is6.to(cpu).reshape(-1), prep.js6.to(cpu)
    L = torch.diagonal(box).to(cpu)
    ar4, ar8 = torch.arange(4), torch.arange(8)
    r = float(np.sqrt(np.float64(rmax2) * (1.0 + sign * 1e-6)))
    S = nbr2.shape[0]
    for s in range(first_block, S):
        for g in range(int(ng[s])):
            for k in range(GJU):
                cid = int(nbr2[s, g, k])
                if cid // BU == s or (cid + 2) * 8 > p.shape[1]:
                    continue
                nonzero = bool(sh[s, g, k].any())
                if want_shift is not None and nonzero != want_shift:
                    continue
                rows_j = cid * 8 + ar8
                shl = sh[s, g, k].to(torch.float32) * L
                xj = p[:, rows_j] + shl[:, None]
                m = int(torch.argmin(xj[0]))
                if float(js6[s, g, 8 * k + m]) <= 0.0:
                    continue
                for h in range(2 * BU):
                    rows_i = s * 32 + h * 4 + ar4
                    a = int(rows_i[torch.argmax(p[0, rows_i])])
                    if float(is6[a]) <= 0.0 or not (
                            int(pm[s, g, 8 * k + m]) >> (a - s * 32)) & 1:
                        continue
                    out = p.clone()
                    xj[0] += p[0, a] + r - xj[0, m]
                    xj[1, m], xj[2, m] = p[1, a], p[2, a]
                    out[:, rows_j] = xj - shl[:, None]
                    return (out.to(plane.device),
                            (s, g, h, k, a, cid * 8 + m))
    raise AssertionError("no live tile with a masked-in LJ pair to place")


def _fold(d, L, layout):
    """d under the rectangular minimum image of the layout's plain
    version: round(d / L) on the table route, floor(d / L + 0.5) on K7a/b
    (the TPU kernels' image)."""
    if layout == "table":
        return d - torch.round(d / L) * L
    return d - torch.floor(d * (1.0 / L) + 0.5) * L


def _pair_r2(p, a, b, L, layout="table", sh=None):
    """float32 r^2 of plane rows a and b of p (3, rows) as the layout's
    plain version computes it: under its minimum image, or (K7c) with b at
    its entry's shift sh (3,) in nm and no image."""
    if sh is not None:
        d = p[:, a] - (p[:, b] + sh)
    else:
        d = _fold(p[:, a] - p[:, b], L, layout)
    return float(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])


def _row_of(prep, ci):
    """The list row of i-clusters ci (K7a: their supercluster's)."""
    return ci // 8 if prep.layout == "super" else ci


def place_table_pair(planes, box, prep, rmax2, sign, periodic=False,
                     first=0):
    """Move one j cluster of a live entry of a per-cluster pack (any
    layout) so that a pair of atoms that take the pair math (pv != 0)
    sits on its tile's boundary at r^2 = rmax2 (1 + sign 1e-6): the
    cluster is translated along x until its lowest-x such atom B (K7c: at
    the entry's shift) lies r beyond the i half's highest-x such atom A,
    and B takes A's y and z, so B's distance to the half's box is the
    pair's; B is then nudged by float32 steps until the pair's r^2 (as the
    plain version computes it) lies on the intended side of rmax2.
    periodic: the pair straddles the periodic boundary (the cluster also
    moves by -L_x; K7c: the entry is one with a nonzero x shift, and with
    periodic False one with no shift).  The entry is the first, from
    i-cluster `first` on, whose j cluster is not the i-cluster.  Returns
    (the moved planes on their device, (cl, e, h, a, b)): i-cluster of the
    range, entry of its row, i half, A's and B's plane rows."""
    cpu = torch.device("cpu")
    p = torch.stack([q.to(cpu) for q in planes])
    nbr, cnt, pv = prep.nbr.to(cpu), prep.cnt.to(cpu), prep.pv.to(cpu)
    v2 = prep.layout == "v2"
    shift = prep.shift.to(cpu) if v2 else None
    L = torch.diagonal(box).to(cpu)
    lim = np.float32(rmax2)
    r = float(np.sqrt(np.float64(rmax2) * (1.0 + sign * 1e-6)))
    ar4, ar8 = torch.arange(4), torch.arange(8)
    for cl in range(first, prep.n_icl):
        ci = prep.i0 + cl
        row = _row_of(prep, cl)
        for e in range(int(cnt[row])):
            jc = int(nbr[row, e])
            rows_j = jc * 8 + ar8
            ok_j = pv[rows_j] > 0
            if jc == ci or not bool(ok_j.any()):
                continue
            sh = None
            if v2:
                across = (bool(shift[row, e, 0] != 0) if periodic
                          else not bool(shift[row, e].any()))
                if not across:
                    continue
                sh = shift[row, e, :3] * L
            xs_j = p[0, rows_j] + (0.0 if sh is None else sh[0])
            b = int(rows_j[ok_j][torch.argmin(xs_j[ok_j])])
            for h in range(2):
                rows_i = ci * 8 + 4 * h + ar4
                ok_i = pv[rows_i] > 0
                if not bool(ok_i.any()):
                    continue
                a = int(rows_i[ok_i][torch.argmax(p[0, rows_i][ok_i])])
                out = p.clone()
                xb = float(p[0, b]) + (0.0 if sh is None else float(sh[0]))
                dx = (float(p[0, a]) + r - xb
                      - (float(L[0]) if periodic and not v2 else 0.0))
                out[0, rows_j] = (p[0, rows_j].double() + dx).float()
                for d in (1, 2):
                    out[d, b] = p[d, a] - (0.0 if sh is None else sh[d])
                step = torch.tensor(float("inf"))
                while not sign * (_pair_r2(out, a, b, L, prep.layout, sh)
                                  - lim) > 0:
                    out[0, b] = torch.nextafter(out[0, b], step)
                return ([out[d].to(planes[d].device) for d in range(3)],
                        (cl, e, h, a, b))
    raise AssertionError("no live entry with a pair to place")


def table_culled_close_pairs(planes, box, prep, consts, block=64):
    """(pairs that take the pair math (pv != 0 both, not the self pair;
    K7c: the entry's mask bit) of a live entry with r^2 < max(rc2, rv2),
    as the pack layout's plain version computes r^2, in tiles that
    cull_table_tiles_plain skips, its keep mask (n_icl, W, 2), the live
    entry mask (n_icl, W))."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster
    keep = nb_cluster.cull_table_tiles_plain(planes, box, prep, consts)
    dev = keep.device
    n_icl, W = prep.n_icl, prep.nbr.shape[1]
    rows = _row_of(prep, torch.arange(n_icl, device=dev))
    live = torch.arange(W, device=dev)[None, :] \
        < prep.cnt[rows][:, None].to(torch.int64)
    L = torch.diagonal(box)
    rmax2 = np.float32(max(consts.rc2, consts.rv2))
    ar = torch.arange(8, device=dev)
    v2 = prep.layout == "v2"
    bad = 0
    for c0 in range(0, n_icl, block):
        ci = torch.arange(c0, min(c0 + block, n_icl), device=dev)
        row = _row_of(prep, ci)
        iid = (prep.i0 + ci)[:, None] * 8 + ar                 # (B, 8)
        jid = prep.nbr[row].long()[..., None] * 8 + ar         # (B, W, 8)
        r2 = 0.0
        for k, (pl, Lx) in enumerate(zip(planes, L)):
            pj = pl[jid]
            if v2:
                pj = pj + (prep.shift[row][..., k] * Lx)[..., None]
            d = pl[iid][:, None, :, None] - pj[:, :, None, :]
            if not v2:
                d = _fold(d, Lx, prep.layout)
            r2 = r2 + d * d                                    # (B, W, 8, 8)
        if v2:
            take = ((prep.jmask[row][:, :, None, :]
                     >> ar[None, None, :, None]) & 1) != 0
        else:
            take = ((prep.pv[iid][:, None, :, None] > 0)
                    & (prep.pv[jid][:, :, None, :] > 0)
                    & (iid[:, None, :, None] != jid[:, :, None, :]))
        take = take & live[ci][..., None, None]
        kept = keep[ci].repeat_interleave(4, 2)[..., None]     # (B, W, 8, 1)
        bad += int((take & ~kept & (r2 < rmax2)).sum())
    return bad, keep, live


def _prep_head(prep, n):
    """prep's first n i-blocks (their lists unchanged)."""
    cut = {f.name: getattr(prep, f.name)[:n].contiguous()
           for f in dataclasses.fields(prep)
           if isinstance(getattr(prep, f.name), torch.Tensor)}
    return dataclasses.replace(prep, **cut,
                               ng_max=int(cut["ng"].max()) if n else 0)


def _v2u_check(name, plane, box, prep, consts, flavours=("F", "VF", "VFV")):
    """K1's launch (i_off 0, the wrapper's split) against plane_gather +
    nb_v2u_plain on the same plane: NaN in exactly the plain version's
    force rows and energy rows, the rest at the gates (F rel 5e-4 of max
    |F|, E and virial rel 1e-4).  Returns {flavour: (kernel, plain)}."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_v2u
    ip, jp = nb_v2u.plane_gather(plane, box, prep)
    out = {}
    for flavour in flavours:
        e, v = flavour != "F", flavour == "VFV"
        split = nb_v2u.launch_split(plane, prep, consts, e, v)
        fk = nb_v2u._launch(plane, 0, box, prep, consts, e, v)
        fp = nb_v2u.nb_v2u_plain(ip, jp, box, prep, consts, e, v)
        torch.cuda.synchronize()
        Fk, Fp = torch.stack(fk[:3], -1), torch.stack(fp[:3], -1)
        same_nan = (torch.equal(torch.isnan(Fk), torch.isnan(Fp))
                    and torch.equal(torch.isnan(fk[3]), torch.isnan(fp[3])))
        fin = ~torch.isnan(Fp).any(-1)
        f_rel, _ = _rel(Fk[fin], Fp[fin])
        rows = ~torch.isnan(fp[3]).any(1)
        e_rel = v_rel = 0.0
        if e:
            ek, ep = (0.5 * o[3][rows, :2].double().sum(0) for o in (fk, fp))
            e_rel = float(((ek - ep).abs() / ep.abs()).max())
        if v:
            v_rel, _ = _rel(*(-0.25 * o[3][rows, 2:5].double().sum(0)
                              for o in (fk, fp)))
        ok = same_nan and f_rel <= F_REL and e_rel <= E_REL and v_rel <= E_REL
        _say(f"v2u edge {name} {flavour}: S={prep.nbr2.shape[0]} G="
             f"{prep.nbr2.shape[1]} ng max {prep.ng_max}, split {split}, "
             f"{'minimum image' if prep.shift is None else 'baked shifts'};"
             f" NaN atoms {int((~fin).sum())} (kernel "
             f"{int(torch.isnan(Fk).any(-1).sum())}), NaN energy rows "
             f"{int((~rows).sum())}; F rel {f_rel:.2e}, E rel {e_rel:.2e}, "
             f"virial rel {v_rel:.2e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"v2u edge case {name} {flavour}: the "
                                 "kernel disagrees with its plain version")
        out[flavour] = (Fk, Fp)
    return out


def phase_v2u_edges(runner, state, caps):
    """K1/K6's edge cases (one body; K6 is the same launch with a cat
    plane and a block offset) against plane_gather + nb_v2u_plain:
    - boundary: on the main path's frame, a masked-in LJ pair placed on its
      tile's box distance at r^2 = rmax2 (1 -+ 1e-6), once with a baked
      shift and once without; beside the gates, the force on its i atom A
      (whose tile sits on the boundary; the moved cluster may land close
      to other atoms, so B's own force can be large) must match the plain
      version to a quarter of the pair's own force (A's force with the
      pair inside minus outside, kernel against plain);
    - nan: one NaN coordinate (an i atom of block 10, and a j lane of its
      neighbours' lists);
    - minimum image on a small box (650 atoms, rc 0.6, no baked shifts)
      and at 12,290 atoms;
    - ng skew: every block ng = 1 but block 0 with ng = G (its groups
      past its own list hold the pad cluster), over all blocks and over the
      first 48 (a split launch);
    each in F, VF and VF+virial."""
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    from gromacs_fep_gpu_tpu_torch.ops import nb_v2u
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    from gromacs_fep_gpu_tpu_torch.ops.pme import pme_grid_size
    t0 = time.perf_counter()
    params = runner.params
    x, box = state.x, state.box
    nlist, _, prep, _ = runner.lists(state)
    consts = nb_v2u.NbConstants.from_params(params, get_beta(params))
    plane = nb_v2u.sorted_plane(x, box, nlist, prep)
    rmax2 = max(consts.rc2, consts.rv2)
    for want_shift in (True, False):
        res = {}
        for sign, where in ((-1.0, "inside"), (1.0, "outside")):
            moved, (s, g, h, k, a, b) = place_boundary_pair(
                plane, box, prep, rmax2, sign, want_shift=want_shift)
            keep = nb_v2u.cull_tiles_plain(moved, 0, box, prep, consts)
            _say(f"v2u edge boundary ({'with' if want_shift else 'no'} "
                 f"shift, {where}): block {s} group {g} half {h} cluster "
                 f"{k}, rows {a} and {b}; tile kept by the cull: "
                 f"{bool(keep[s, g, h, k])}")
            res[where] = _v2u_check(f"boundary {where}", moved, box, prep,
                                    consts, ("F", "VF"))
        for flavour in ("F", "VF"):
            # A's force inside minus outside: the placed pair's own force
            # (A's other pairs are the same sums in both runs)
            fk, fp = ((res["inside"][flavour][i].reshape(-1, 3)[a]
                       - res["outside"][flavour][i].reshape(-1, 3)[a])
                      for i in (0, 1))
            pf, dk = float(fp.norm()), float((fk - fp).norm())
            _say(f"  row {a} {flavour}: the pair's own force {pf:.4e} "
                 f"(plain), kernel's minus plain's {dk:.3e}")
            if not (pf > 0.0 and dk <= 0.25 * pf):
                raise AssertionError("v2u edge boundary: the kernel lost or "
                                     "gained the placed pair")
    nan_plane = plane.clone()
    nan_plane[0, 32 * 10 + 5] = float("nan")
    _v2u_check("nan", nan_plane, box, prep, consts)

    small = 6
    sparams = params.replace(
        rcoulomb=0.6, rvdw=0.6, rlist=0.6,
        pme_grid=pme_grid_size((small * 0.31,) * 3, 0.12))
    ssys, sst = solvation_system(n_side=small, seed=0, device=x.device)
    srun = MdRunner(ssys, sparams, RunnerConfig(super_nnbr=128,
                                                baked_shifts=False))
    snl, _, sprep, _ = srun.lists(sst)
    sconsts = nb_v2u.NbConstants.from_params(sparams, get_beta(sparams))
    _v2u_check("minimum image, 650 atoms",
               nb_v2u.sorted_plane(sst.x, sst.box, snl, sprep), sst.box,
               sprep, sconsts)
    mrun = MdRunner(runner.system, params, RunnerConfig(
        super_nnbr=caps[0], fep_max_nbr=caps[1], baked_shifts=False))
    mnl, _, mprep, _ = mrun.lists(state)
    _v2u_check(f"minimum image, {x.shape[0]:,} atoms",
               nb_v2u.sorted_plane(x, box, mnl, mprep), box, mprep, consts)

    S, G = prep.nbr2.shape[:2]
    ng = torch.ones_like(prep.ng)
    ng[0] = G
    skew = dataclasses.replace(prep, ng=ng, ng_max=G)
    _v2u_check("ng skew", plane, box, skew, consts)
    _v2u_check("ng skew, 48 blocks", plane, box, _prep_head(skew, 48),
               consts)
    _say(f"v2u edge phase took {time.perf_counter() - t0:.1f} s")


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
    kernels and host ops.  Returns (the idle share, kernels per step)."""
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
    return 1.0 - busy_ms / nsteps / ms_step, n_kern / nsteps


def _run_windows(runner_for, start, params, ladder, smi, what,
                 volumes=None, ms_steps=None):
    """Windows WINDOWS, each WINDOW_STEPS from `start` (set to the window)
    through _drive, with their checks: Delta H finite on exactly the sweep
    steps, own window ~0, temperature in its band; dhdl.xvg of each window
    written and read back; BAR of the leg printed.  Returns (launches
    summed over the windows, the last window's final state, its log); each
    window's ms/step is appended to the list `ms_steps` if one is given."""
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
            if ms_steps is not None:
                ms_steps.append(ms_step)
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
        dt=EQ_DT, tau_t=0.1, nsttcouple=1)
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
    pattern, and the pattern against the expected flavour counts of MTS2,
    nstpcouple 10 and nstdhdl 100: per window of n steps S n/100, R
    n/10 - n/100, F n/2 - n/10, f n/2; the equilibration likewise without
    the sweep),
    finite values, density in DENSITY_BAND at every sample, and the
    windows' volumes within MAX_DV of V_eq, the volume after the NPT
    equilibration.  The NVT-equilibrated start is ~2 % denser than TIP3P
    at 1 bar with the tail correction; the NPT_EQ_STEPS steps relax it, and
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
    n = NPT_EQ_STEPS
    pat = eq._flavor_pattern(0, n)
    want = {"R": n // 10, "F": n // 2 - n // 10, "f": n // 2}
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
    if counts["nb_v2u_VFV"] != n // 10 or counts["nb_v2u_F"] != n - n // 10:
        raise AssertionError(f"NPT equilibration launches {counts}")

    n = WINDOW_STEPS
    for w in WINDOWS:
        pat = runner_for(seed=w)._flavor_pattern(0, n)
        if {c: pat.count(c) for c in set(pat)} != {
                "S": n // 100, "R": n // 10 - n // 100,
                "F": n // 2 - n // 10, "f": n // 2}:
            raise AssertionError(f"NPT window {w} flavours {pat!r}")
    wvols, cr_ms = [], []
    total, state_w, lg_w = _run_windows(runner_for, state, params, ladder,
                                        smi, "NPT window", wvols, cr_ms)
    n_win = len(WINDOWS)
    if total["nb_v2u_VFV"] != n_win * (n // 10) \
            or total["nb_v2u_F"] != n_win * (n - n // 10) \
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
    if not bool(torch.isfinite(p_on).all()) or p_on.numel() != n // 10:
        raise AssertionError("NPT window: pressure not finite on exactly "
                             f"the {n // 10} pressure steps")
    if not DENSITY_BAND[0] <= rho <= DENSITY_BAND[1] or not all(
            DENSITY_BAND[0] <= density(v) <= DENSITY_BAND[1] for v in all_v):
        raise AssertionError(f"NPT density left {DENSITY_BAND} g/cm^3")
    if dv >= MAX_DV:
        raise AssertionError(f"NPT volume moved by {dv:.4f} of V_eq")
    pr_total = _pr_windows(system, params, ladder, caps, state_w, density,
                           cr_ms, smi)

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
    return rows, total, pr_total


def _box_edges(state):
    return [float(b) for b in torch.diagonal(state.box)]


def _pr_windows(system, params, ladder, caps, start, density, cr_ms, smi):
    """Parrinello-Rahman after the C-rescale windows, from the state they
    end in: one window of WINDOW_STEPS at window WINDOWS[-1]'s lambda
    (isotropic, tau_p PR_TAU_P, with the sweep), then PR_SEMI_STEPS of
    semiisotropic coupling (ref-p and compressibility the same for z, no
    sweep), each through _drive (exact launches, finite values).  Gates:
    the density in DENSITY_BAND at every 100 steps; the window's |V - V0| /
    V0 below MAX_DV (V0: its start); the window keeps the ratios of the box
    edges to 1e-5 (isotropic PR moves every edge by the same relative
    amount); the semiisotropic run keeps L_x = L_y to fp32 rounding (two
    ulp) and its box velocity finite.  Prints the window's ms/step beside
    the C-rescale windows'.  Returns the launches of both runs."""
    from gromacs_fep_gpu_tpu_torch.core.types import PcouplType
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    w = WINDOWS[-1]
    pr = params.replace(pcoupl=PcouplType.PARRINELLO_RAHMAN, tau_p=PR_TAU_P)

    def runner(p, all_lambda, seed):
        return MdRunner(system, p, RunnerConfig(
            super_nnbr=caps[0], fep_max_nbr=caps[1], seed=seed),
            all_lambda=all_lambda)
    state = start.replace(lam=torch.tensor(ladder[w], device=start.x.device),
                          fep_state=w, step=0)
    v0 = float(torch.prod(torch.diagonal(state.box)))
    e0 = _box_edges(state)
    vols = []
    state, lg, sec, counts = _drive(runner(pr, ladder, 200 + w), state,
                                    WINDOW_STEPS, f"PR window {w}", vols)
    e1 = _box_edges(state)
    shape = max(abs(e1[a] / e1[0] - e0[a] / e0[0]) for a in (1, 2))
    dv = max(abs(v - v0) for v in vols) / v0
    bv = torch.diagonal(state.coupling.boxv)
    p_on = lg.pres[torch.isfinite(lg.pres)]
    n_p = WINDOW_STEPS // pr.nstpcouple
    ms = sec / WINDOW_STEPS * 1e3
    _say(f"PR window {w} (Parrinello-Rahman isotropic, tau_p {PR_TAU_P} "
         f"ps, nstpcouple {pr.nstpcouple}): {WINDOW_STEPS} steps, "
         f"{ms:.3f} ms/step against the C-rescale windows' "
         f"{[round(m, 3) for m in cr_ms]} ms/step in this call on {smi}; "
         f"launches {counts}; volume every 100 steps "
         f"{[round(v, 4) for v in vols]} nm^3 (start {v0:.4f}), max |V - V0|"
         f" / V0 {dv:.4f}; density {density(vols[-1]):.4f} g/cm^3; box "
         f"edges {[round(b, 6) for b in e1]} nm, edge-ratio drift "
         f"{shape:.2e}; boxv {[float(b) for b in bv]} nm/ps; mean P "
         f"{float(p_on.mean()):.1f} bar over {p_on.numel()} pressure steps")
    if p_on.numel() != n_p or not bool(torch.isfinite(bv).all()):
        raise AssertionError("PR window: pressure not finite on exactly the "
                             f"{n_p} pressure steps, or boxv not finite")
    if not all(DENSITY_BAND[0] <= density(v) <= DENSITY_BAND[1]
               for v in vols):
        raise AssertionError(f"PR window: density left {DENSITY_BAND}")
    if dv >= MAX_DV:
        raise AssertionError(f"PR window: volume moved by {dv:.4f} of V0")
    if not shape <= PR_SHAPE_TOL:
        raise AssertionError(f"PR window: the box edges' ratios moved by "
                             f"{shape:.2e}")

    semi = pr.replace(pcoupltype="semiisotropic")
    vols2 = []
    state2, lg2, sec2, counts2 = _drive(runner(semi, None, 300 + w), state,
                                        PR_SEMI_STEPS, "semiisotropic PR",
                                        vols2)
    e2 = _box_edges(state2)
    lx, ly = state2.box[0, 0], state2.box[1, 1]
    ulp = float(torch.nextafter(lx, lx + 1.0) - lx)
    bv2 = torch.diagonal(state2.coupling.boxv)
    _say(f"semiisotropic PR ({PR_SEMI_STEPS} steps from the PR window): "
         f"{sec2 / PR_SEMI_STEPS * 1e3:.3f} ms/step, launches {counts2}; box "
         f"edges {[round(b, 6) for b in e2]} nm, |L_x - L_y| "
         f"{abs(float(lx - ly)):.3e} nm (ulp {ulp:.3e}), L_z / L_x "
         f"{e2[2] / e2[0]:.6f} (start {e1[2] / e1[0]:.6f}); boxv "
         f"{[float(b) for b in bv2]} nm/ps; density "
         f"{density(vols2[-1]):.4f} g/cm^3")
    if abs(float(lx - ly)) > 2.0 * ulp or not bool(
            torch.isfinite(bv2).all()):
        raise AssertionError("semiisotropic PR: L_x != L_y or boxv not "
                             "finite")
    if not all(DENSITY_BAND[0] <= density(v) <= DENSITY_BAND[1]
               for v in vols2):
        raise AssertionError(f"semiisotropic PR: density left "
                             f"{DENSITY_BAND}")
    return {k: counts.get(k, 0) + counts2.get(k, 0) for k in counts}



def _lb_system(n_side, device):
    """The solvation model's system with its sigma/epsilon mixed by
    Lorentz-Berthelot (comb-rule 2, the AMBER/CHARMM rule) and the model's
    zeroed rows for the water H and the dummy type, from the public
    build functions, with the CHARMM setting constraints = h-bonds: the
    ligand's four C-H bonds (all its bonds) become LINCS rows through
    make_hbond_constraints(all_bonds=True); its state is
    solvation_system's."""
    from gromacs_fep_gpu_tpu_torch.core.topology import (
        build_system, lj_table_from_sigma_eps)
    from gromacs_fep_gpu_tpu_torch.io.topio import make_hbond_constraints
    from gromacs_fep_gpu_tpu_torch.models import solvation, water
    sigma = [water.O_SIGMA, 0.1, solvation.LIG_C_SIGMA,
             solvation.LIG_H_SIGMA, 0.1]
    eps = [water.O_EPS, 0.0, solvation.LIG_C_EPS, solvation.LIG_H_EPS, 0.0]
    nbfp = lj_table_from_sigma_eps(sigma, eps, comb_rule=2)
    for k in (1, 4):
        nbfp[k, :, :] = 0.0
        nbfp[:, k, :] = 0.0
    lig = solvation.methane_like_ligand(True)
    make_hbond_constraints(lig, all_bonds=True)
    return build_system([(lig, 1), (water.tip3p_moltype(), n_side ** 3 - 1)],
                        nbfp, device=device)


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
    kept, bad = _table_kept(planes, box, prep, consts)
    shape = f"; warps per i-cluster {prep.warps}, tiles kept {kept:.4f}"
    if bad:
        raise AssertionError(f"the {layout} cull skipped pairs in the "
                             "cut-off")
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
             f"{n_pairs}{shape}; F "
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
        out, n_pairs = _cluster_kernel_rows(
            r, state, timer,
            ("F", "VF") if layout == "table" else ("F", "VF", "VFV"),
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
    idle, _ = _profile_window(prod, state, params.nstlist, ms_step, top=6)
    _say(f"CHARMM production idle share {idle:.3f} on {smi}")
    for r in rows:
        r["launches"] = counts[r["name"]]

    npt = MdRunner(system, params.replace(
        pcoupl=PcouplType.C_RESCALE, tau_p=1.0, compressibility=4.5e-5,
        nstpcouple=10), RunnerConfig(nnbr=prod.config.nnbr,
                                     fep_max_nbr=prod.config.fep_max_nbr))
    prod_state = state
    v0 = float(torch.prod(torch.diagonal(state.box)))
    state, lg, sec, counts = _drive(npt, state.replace(step=0),
                                    CHARMM_NPT_STEPS, "CHARMM C-rescale")
    p_on = lg.pres[torch.isfinite(lg.pres)]
    v1 = float(torch.prod(torch.diagonal(state.box)))
    rho = float(system.mass_a.sum()) / v1 * AMU_PER_NM3_IN_G_PER_CM3
    dev = _constraint_deviation(system, state)
    _say(f"CHARMM C-rescale on the table route: {CHARMM_NPT_STEPS} steps, "
         f"{sec / CHARMM_NPT_STEPS * 1e3:.3f} ms/step, launches "
         f"{ {k: v for k, v in counts.items() if k.startswith('nb_') and v} }"
         f"; mean P {float(p_on.mean()):.1f} bar over {p_on.numel()} "
         f"pressure steps (the SETTLE and LINCS virial in each); density "
         f"{rho:.4f} g/cm^3 (band {DENSITY_BAND}), |dV|/V "
         f"{abs(v1 - v0) / v0:.2e} (< {MAX_DV}); the "
         f"{system.lincs.atoms.shape[0]} LINCS rows' max |r - d| / d "
         f"{dev:.2e}")
    if counts["nb_table_VFV"] != CHARMM_NPT_STEPS // 10 \
            or not bool(torch.isfinite(p_on).all()):
        raise AssertionError("CHARMM C-rescale: virial flavour launches or "
                             "pressure")
    if not (DENSITY_BAND[0] <= rho <= DENSITY_BAND[1]
            and abs(v1 - v0) / v0 < MAX_DV):
        raise AssertionError(f"CHARMM C-rescale: density {rho}, volume "
                             f"{v0} -> {v1}")
    rows[2]["launches"] = counts["nb_table_VFV"]
    return rows, prod_state, prod.config.nnbr


def _bits_equal(a, b):
    """a and b hold the same bits (NaN included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _table_check(name, planes, box, prep, consts, flavours=None):
    """The per-cluster kernel (nb_cluster_cuda) of the pack's layout
    against its plain version (nb_cluster_plain: table_plain or k7_plain)
    on the same inputs, in every flavour of the layout (the table route's
    F, VF and VF+virial, K7a/b/c's F and VF) unless `flavours` says: NaN
    in exactly the plain version's force rows and energy rows, the rest
    at the gates (F rel 5e-4 of max |F|, E and virial rel 1e-4); each
    launch twice, the two bit-identical (the fixed-order reduction).
    Returns {flavour: (kernel, plain)} of the (n_icl * 8, 3) forces."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster
    if flavours is None:
        flavours = tuple(nb_cluster.launches[prep.layout])
    out = {}
    for flavour in flavours:
        e, v = flavour != "F", flavour == "VFV"
        fk = nb_cluster.nb_cluster_cuda(planes, box, prep, consts, e, v)
        again = nb_cluster.nb_cluster_cuda(planes, box, prep, consts, e, v)
        fp = nb_cluster.nb_cluster_plain(planes, box, prep, consts, e, v)
        torch.cuda.synchronize()
        same = all(_bits_equal(a, b) for a, b in zip(fk, again))
        Fk, Fp = torch.stack(fk[:3], -1), torch.stack(fp[:3], -1)
        same_nan = (torch.equal(torch.isnan(Fk), torch.isnan(Fp))
                    and torch.equal(torch.isnan(fk[3]), torch.isnan(fp[3])))
        fin = ~torch.isnan(Fp).any(-1)
        f_rel = _rel(Fk[fin], Fp[fin])[0] if bool(fin.any()) else 0.0
        rows = ~torch.isnan(fp[3]).any(1)
        e_rel = v_rel = 0.0
        if e:
            ek, ep = (0.5 * o[3][rows, :2].double().sum(0) for o in (fk, fp))
            e_rel = float(((ek - ep).abs() / ep.abs().clamp(min=1e-30))
                          .max())
        if v:
            v_rel, _ = _rel(*(-0.25 * o[3][rows, 2:5].double().sum(0)
                              for o in (fk, fp)))
        ok = (same and same_nan and f_rel <= F_REL and e_rel <= E_REL
              and v_rel <= E_REL)
        _say(f"{prep.layout} edge {name} {flavour}: {prep.n_icl} "
             f"i-clusters from "
             f"{prep.i0}, W {prep.nbr.shape[1]}, live {int(prep.cnt.sum())}"
             f", warps {prep.warps}; NaN atoms {int((~fin).sum())} (kernel "
             f"{int(torch.isnan(Fk).any(-1).sum())}), NaN energy rows "
             f"{int((~rows).sum())}; F rel {f_rel:.2e}, E rel {e_rel:.2e}, "
             f"virial rel {v_rel:.2e}; repeat bit-identical {same} -> "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{prep.layout} edge case {name} "
                                 f"{flavour}: the kernel disagrees with its "
                                 "plain version")
        out[flavour] = (Fk, Fp)
    return out


def _table_kept(planes, box, prep, consts):
    """Share of the live entries' tiles that the kernel's cull keeps
    (cull_table_tiles_plain, any layout), and the pairs in the cut-off in
    skipped tiles (0 for an exact cull)."""
    bad, keep, live = table_culled_close_pairs(planes, box, prep, consts)
    return float(keep[live].float().mean()), bad


def _edge_cases(frame, planes, box, prep, consts, n_clusters,
                flavours=None):
    """The edge cases every per-cluster layout shares, each held by
    _table_check: the frame itself (with the tiles the cull keeps and the
    warps per i-cluster); a pair placed on its tile's boundary at r^2 =
    rmax2 (1 -+ 1e-6), in one box image and across the periodic boundary
    (K7c: across a baked shift), whose own force on its i atom A (inside
    minus outside) must match the plain version's to a quarter of itself;
    a NaN coordinate (an atom of a cluster that other rows list); one row
    at W entries and every other row at 1, at the wrapper's warps and at 1
    and 16 warps per i-cluster; every third row empty.  The frame and the
    NaN atom run every flavour of the layout; the boundary pair, the skewed
    and the empty rows (the ring, the cull and the deal of entries, which
    no flavour changes) run `flavours` (None: every flavour)."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster
    layout = prep.layout
    kept, bad = _table_kept(planes, box, prep, consts)
    _say(f"{layout} edge production frame: {prep.n_icl} i-clusters, "
         f"longest row {prep.cnt_max}, warps per i-cluster {prep.warps}, "
         f"tiles kept {kept:.4f}, pairs in the cut-off in skipped tiles "
         f"{bad}")
    if bad:
        raise AssertionError(f"the {layout} cull skipped pairs in the "
                             "cut-off")
    _table_check(frame, planes, box, prep, consts)

    rmax2 = max(consts.rc2, consts.rv2)
    for periodic in (False, True):
        res = {}
        for sign, where in ((-1.0, "inside"), (1.0, "outside")):
            moved, (cl, e, h, a, b) = place_table_pair(
                planes, box, prep, rmax2, sign, periodic=periodic)
            keep = nb_cluster.cull_table_tiles_plain(moved, box, prep,
                                                     consts)
            image = "periodic" if periodic else "one image"
            _say(f"{layout} edge boundary ({image}, {where}): i-cluster "
                 f"{cl} entry {e} half {h}, rows {a} and {b}; tile kept by "
                 f"the cull: {bool(keep[cl, e, h])}")
            res[where] = _table_check(f"boundary {where}", moved, box, prep,
                                      consts, flavours)
        for flavour in res["inside"]:
            fk, fp = ((res["inside"][flavour][i][a] -
                       res["outside"][flavour][i][a]) for i in (0, 1))
            pf, dk = float(fp.norm()), float((fk - fp).norm())
            _say(f"  row {a} {flavour}: the pair's own force {pf:.4e} "
                 f"(plain), kernel's minus plain's {dk:.3e}")
            if not (pf > 0.0 and dk <= 0.25 * pf):
                raise AssertionError(f"{layout} edge boundary: the kernel "
                                     "lost or gained the placed pair")

    row = int(prep.nbr[10, 3]) * 8 + 5
    nan_planes = [p.clone() for p in planes]
    nan_planes[0][row] = float("nan")
    _table_check("nan", nan_planes, box, prep, consts)

    C, W = n_clusters, prep.nbr.shape[1]
    nbr = torch.full_like(prep.nbr, C)
    nbr[:, 0] = prep.nbr[:, 0]
    nbr[0] = torch.arange(W, device=nbr.device, dtype=nbr.dtype) % C
    cnt = torch.ones_like(prep.cnt)
    cnt[0] = W
    skew = dataclasses.replace(prep, nbr=nbr, cnt=cnt, cnt_max=W)
    for w in sorted({prep.warps, 1, nb_cluster.MAX_WARPS}):
        _table_check(f"skew ({w} warps)", planes, box,
                     dataclasses.replace(skew, warps=w), consts, flavours)
    nbr = prep.nbr.clone()
    nbr[::3] = C
    cnt = prep.cnt.clone()
    cnt[::3] = 0
    _table_check("empty rows", planes, box,
                 dataclasses.replace(prep, nbr=nbr, cnt=cnt), consts,
                 flavours)


def phase_table_edges(device, state, nnbr):
    """The table kernel's edge cases against table_plain (every flavour,
    each launch twice and bit-identical, NaN in exactly the plain
    version's rows):
    - _edge_cases on the 12,290-atom CHARMM frame (the production
      state): the frame, the boundary pair, a NaN atom, skewed and empty
      rows;
    - 64 atom types (the table padded) at 16 warps per i-cluster;
    - an i-range pack with i0 > 0 (parallel/spatial.py _range_pack);
    - every vdW modifier with every Coulomb type in the LJ-table and the
      sqrt(c6)/sqrt(c12) modes at 650 atoms (rc 0.75, rvdw-switch 0.6)."""
    from gromacs_fep_gpu_tpu_torch.core.types import CoulombType, VdwModifier
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster
    from gromacs_fep_gpu_tpu_torch.ops.cluster_nb import lj_table_mode
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import NbConstants
    from gromacs_fep_gpu_tpu_torch.ops.pairlist import build_cluster_pairlist
    from gromacs_fep_gpu_tpu_torch.ops.pme import pme_grid_size
    from gromacs_fep_gpu_tpu_torch.parallel.spatial import _range_pack
    t0 = time.perf_counter()
    system = _lb_system(N_SIDE, device)
    params = _charmm_params()
    runner = MdRunner(system, params, RunnerConfig(nnbr=nnbr))
    box = state.box
    nlist, _, prep, _ = runner.lists(state)
    consts = NbConstants.from_params(params, get_beta(params))
    planes = nb_cluster.gather_planes(state.x, box, nlist, prep)
    _edge_cases(f"{state.x.shape[0]:,}-atom CHARMM frame", planes, box,
                prep, consts, nlist.n_clusters)
    # 64 atom types (the kernel's most): the table padded with zero rows,
    # shared memory past 48 KB at 16 warps
    T = prep.nbfp.shape[0]
    wide = torch.zeros((nb_cluster.MAX_TYPES,) * 2 + (2,),
                       dtype=prep.nbfp.dtype, device=prep.nbfp.device)
    wide[:T, :T] = prep.nbfp
    _table_check(f"{nb_cluster.MAX_TYPES} types, 16 warps", planes, box,
                 dataclasses.replace(prep, nbfp=wide,
                                     warps=nb_cluster.MAX_WARPS), consts)
    c0, c1 = prep.n_icl // 4, prep.n_icl // 2
    part = _range_pack(prep, c0, c1, planes[0].device)
    kept, bad = _table_kept(planes, box, part, consts)
    _say(f"table edge i-range [{c0}, {c1}): warps {part.warps}, tiles kept "
         f"{kept:.4f}, pairs in the cut-off in skipped tiles {bad}")
    if bad:
        raise AssertionError("the table cull skipped pairs in the cut-off")
    _table_check(f"i-range i0 {c0}", planes, box, part, consts)

    n_side = 6
    lb = _lb_system(n_side, device)
    geo, sst = solvation_system(n_side=n_side, seed=0, device=device)
    for coulomb in (CoulombType.CUTOFF, CoulombType.REACTION_FIELD,
                    CoulombType.PME):
        for modifier in VdwModifier:
            sp = _params(mts=True).replace(
                coulomb=coulomb, rcoulomb=0.75, rvdw=0.75, rlist=0.8,
                rvdw_switch=0.6, vdw_modifier=modifier,
                pme_grid=pme_grid_size((n_side * 0.31,) * 3, 0.12))
            sconsts = NbConstants.from_params(
                sp, get_beta(sp) if coulomb == CoulombType.PME else None)
            for sys_ in (lb, geo):
                mode = lj_table_mode(sys_.nbfp.cpu().numpy())
                sl = build_cluster_pairlist(sst.x, sst.box, sys_, 0.8,
                                            nnbr=192)
                if int(sl.n_overflow):
                    raise AssertionError("650-atom list overflowed")
                sprep = nb_cluster.prepare_table(sl, sys_.nbfp, mode,
                                                 cnt_max=int(sl.max_count))
                _table_check(f"650 atoms {coulomb.value} "
                             f"{modifier.value} {mode}",
                             nb_cluster.gather_planes(sst.x, sst.box, sl,
                                                      sprep),
                             sst.box, sprep, sconsts)
    _say(f"table edge phase took {time.perf_counter() - t0:.1f} s")


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


def _lone_union_entry(planes, box, prep, consts, n_clusters):
    """K7a: a union row holding a j cluster in range (a pair that takes the
    pair math inside max(rc, rv)) of exactly one of its supercluster's 8
    i-clusters.  The pack is held by _table_check as it is and with that
    entry's cluster replaced by the far dummy cluster (the deal of entries
    to warps unchanged); between the two, the kernel's forces on the other
    7 i-clusters must be bit-identical (the entry adds nothing to them),
    and the entry's own force on the one (with minus without) must match
    the plain version's to a quarter of itself: its pairs lie near the
    cut-off, where a force is a difference of terms ~1e4 times larger (as
    for _edge_cases' boundary pair)."""
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster
    x = torch.stack(planes, -1)
    dev = x.device
    L = torch.diagonal(box)
    rmax2 = max(consts.rc2, consts.rv2)
    ar = torch.arange(8, device=dev)
    for s in range(prep.nbr.shape[0]):
        n = int(prep.cnt[s])
        iid = (s * 8 + ar)[:, None] * 8 + ar                   # (8 cl, 8 a)
        jid = prep.nbr[s, :n].long()[:, None] * 8 + ar          # (n, 8 j)
        d = _fold(x[iid][:, :, None, None, :] - x[jid][None, None], L,
                  "super")
        r2 = (d * d).sum(-1)                                    # (8, 8, n, 8)
        take = ((prep.pv[iid] > 0)[:, :, None, None]
                & (prep.pv[jid] > 0)[None, None]
                & (iid[:, :, None, None] != jid[None, None]))
        hit = (take & (r2 < rmax2)).any(3).any(1)               # (8 cl, n)
        lone = torch.nonzero(hit.sum(0) == 1)
        if lone.numel():
            e = int(lone[0, 0])
            own = int(torch.nonzero(hit[:, e])[0, 0])
            break
    else:
        raise AssertionError("no union entry in range of one i-cluster")
    nbr = prep.nbr.clone()
    nbr[s, e] = n_clusters
    without = dataclasses.replace(prep, nbr=nbr)
    keep = nb_cluster.cull_table_tiles_plain(planes, box, prep, consts)
    _say(f"super edge lone union entry: row {s} entry {e} (j cluster "
         f"{int(prep.nbr[s, e])}) in range of i-cluster {8 * s + own} "
         f"only; its tiles kept per i-cluster "
         f"{[int(keep[8 * s + c, e].sum()) for c in range(8)]}")
    res = _table_check("lone union entry", planes, box, prep, consts)
    res_wo = _table_check("lone union entry replaced", planes, box, without,
                          consts)
    for flavour in res:
        (fk, fp), (gk, gp) = res[flavour], res_wo[flavour]
        rows = slice(64 * s, 64 * s + 64)
        fk, fp, gk, gp = (t[rows].reshape(8, 8, 3) for t in (fk, fp, gk, gp))
        others = [c for c in range(8) if c != own]
        same = _bits_equal(fk[others], gk[others])
        pf = float((fp[own] - gp[own]).norm())
        dk = float(((fk[own] - gk[own]) - (fp[own] - gp[own])).norm())
        _say(f"  {flavour}: the other 7 i-clusters bit-identical {same}; "
             f"the entry's own force {pf:.4e} (plain), kernel's minus "
             f"plain's {dk:.3e}")
        if not (same and pf > 0.0 and dk <= 0.25 * pf):
            raise AssertionError(f"super edge lone union entry {flavour}: "
                                 "the entry reached another i-cluster, or "
                                 "the kernel lost or gained its force")


def phase_k7_edges(system, params, state, caps):
    """K7a/b/c's edge cases against k7_plain (each launch twice and
    bit-identical, NaN in exactly the plain version's rows):
    - _edge_cases on each layout's pack of the main path's frame: the
      frame (tiles kept, warps) and a NaN atom in F, VF and VF+virial, the
      boundary pair in one image and across the periodic boundary (K7c:
      across a baked shift), the skewed rows at 1, 16 and the wrapper's
      warps and empty rows in F and VF;
    - each layout's virial (VF+virial kernel, Xi_aa = -1/4 sum of its
      partials) against the table route's kernel on the same frame, rel
      1e-4 of max |Xi_aa|: K7a's union rows and K7c's baked shifts count
      each pair of the cut-off as the table route does;
    - K7a: a union row holding only a j cluster in range of one of its 8
      i-clusters (_lone_union_entry), every flavour;
    - cut-off, reaction field and PME on every layout at 1,538 atoms
      (n_side 8, rc 0.5, rlist 0.55: the smallest lattice box on which
      K7c's per-entry shifts hold; at 650 atoms the v2 layout raises, as
      the JAX runner does), every flavour;
    - K7_NPT_STEPS C-rescale steps of the main path on each layout
      (nstpcouple 10: its VF+virial kernel on the pressure steps) through
      _drive, pressure finite on exactly those steps.
    Returns the VF+virial launches of the C-rescale steps."""
    from gromacs_fep_gpu_tpu_torch.core.types import (CoulombType,
                                                      PcouplType,
                                                      VdwModifier)
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    from gromacs_fep_gpu_tpu_torch.ops import nb_cluster
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    from gromacs_fep_gpu_tpu_torch.ops.nb_v2u import NbConstants
    from gromacs_fep_gpu_tpu_torch.ops.pairlist import build_cluster_pairlist
    from gromacs_fep_gpu_tpu_torch.ops.pme import pme_grid_size
    t0 = time.perf_counter()
    box = state.box
    consts = NbConstants.from_params(params, get_beta(params))

    def lists(layout):
        runner = MdRunner(system, params, RunnerConfig(
            layout=layout, super_nnbr=caps[0], fep_max_nbr=caps[1]))
        return runner.lists(state)[:3:2]
    vir_ref = nb_cluster.cluster_forces(state.x, box, *lists("table"),
                                        consts, True, True)[3].double()
    for layout in K7_LAYOUTS:
        nlist, prep = lists(layout)
        planes = nb_cluster.gather_planes(state.x, box, nlist, prep)
        _edge_cases(f"{state.x.shape[0]:,}-atom main-path frame", planes,
                    box, prep, consts, nlist.n_clusters, ("F", "VF"))
        if layout == "super":
            _lone_union_entry(planes, box, prep, consts, nlist.n_clusters)
        vir = nb_cluster.cluster_forces(state.x, box, nlist, prep, consts,
                                        True, True)[3].double()
        v_rel, _ = _rel(vir, vir_ref)
        _say(f"{layout} virial against the table route's on the main-path "
             f"frame: {[round(float(v), 3) for v in vir]} against "
             f"{[round(float(v), 3) for v in vir_ref]} kJ/mol, rel "
             f"{v_rel:.2e} -> {'ok' if v_rel <= E_REL else 'FAIL'}")
        if not v_rel <= E_REL:
            raise AssertionError(f"the {layout} virial disagrees with the "
                                 "table route's")

    n_side, rlist = 8, 0.55
    small, sst = solvation_system(n_side=n_side, seed=0,
                                  device=state.x.device)
    for coulomb in (CoulombType.CUTOFF, CoulombType.REACTION_FIELD,
                    CoulombType.PME):
        sp = _params(mts=True).replace(
            coulomb=coulomb, rcoulomb=0.5, rvdw=0.5, rlist=rlist,
            vdw_modifier=VdwModifier.POTENTIAL_SHIFT,
            pme_grid=pme_grid_size((n_side * 0.31,) * 3, 0.12))
        sconsts = NbConstants.from_params(
            sp, get_beta(sp) if coulomb == CoulombType.PME else None)
        for layout in K7_LAYOUTS:
            sup = layout == "super"
            sl = build_cluster_pairlist(
                sst.x, sst.box, small, rlist, nnbr=0 if sup else 192,
                super_nnbr=448 if sup else None,
                super_block=8 if sup else 4,
                compute_shifts=layout == "v2")
            flags = (sl.super_overflow if sup else sl.n_overflow,
                     sl.shift_overflow if layout == "v2" else 0)
            if any(int(f) for f in flags):
                raise AssertionError(f"{small.n_atoms}-atom {layout} list "
                                     f"overflowed or lost its shifts")
            sprep = nb_cluster.PREPARE[layout](
                sl, small.nbfp, cnt_max=int(sl.super_max_count if sup
                                            else sl.max_count))
            _table_check(f"{small.n_atoms} atoms {coulomb.value}",
                         nb_cluster.gather_planes(sst.x, sst.box, sl, sprep),
                         sst.box, sprep, sconsts)
    _say(f"K7 edge phase took {time.perf_counter() - t0:.1f} s")

    npt = params.replace(pcoupl=PcouplType.C_RESCALE, tau_p=1.0,
                         compressibility=4.5e-5, nstpcouple=10)
    counts_vfv = {}
    for layout in K7_LAYOUTS:
        runner = MdRunner(system, npt, RunnerConfig(
            layout=layout, super_nnbr=caps[0], fep_max_nbr=caps[1], seed=4))
        st, lg, sec, counts = _drive(runner, state.replace(step=0),
                                     K7_NPT_STEPS, f"layout {layout} NPT")
        p_on = lg.pres[torch.isfinite(lg.pres)]
        key = f"nb_{layout}_VFV"
        _say(f"layout {layout} C-rescale: {K7_NPT_STEPS} steps, "
             f"{sec / K7_NPT_STEPS * 1e3:.3f} ms/step, {key} "
             f"{counts[key]}, P {[round(float(v), 1) for v in p_on]} bar, "
             f"box {float(st.box[0, 0]):.6f} nm (from "
             f"{float(state.box[0, 0]):.6f})")
        if p_on.numel() != K7_NPT_STEPS // npt.nstpcouple \
                or counts[key] != p_on.numel():
            raise AssertionError(f"layout {layout} C-rescale: pressure not "
                                 "finite on exactly its pressure steps")
        counts_vfv[key] = counts[key]
    return counts_vfv


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
    n_pairs, n_bytes, kept = 0, 0, []
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
            n_bytes += _v2u_bytes(dom, i_off, 2)
            kept.append(_tiles_kept(cat, i_off, box, dom, consts))
        n_pairs //= 2
        flops = FLOPS_PAIR
    else:
        for cat, dom in zip(cats, doms):
            n_pairs += _pairs_in_cut(list(cat), box, dom,
                                     max(consts.rc2, consts.rv2))
            k, bad = _table_kept(list(cat), box, dom, consts)
            if bad:
                raise AssertionError("the table cull skipped pairs in the "
                                     "cut-off")
            if bool((dom.cnt > 0).any()):
                kept.append(k)
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
        if not k6:
            detail = (f"; warps per i-cluster "
                      f"{sorted({d.warps for d in doms})} (longest row "
                      f"{doms[0].cnt_max}), tiles kept {min(kept):.4f}-"
                      f"{max(kept):.4f}")
        else:
            splits = [nb_v2u.launch_split(c, d, consts, energy)
                      for c, d in zip(cats, doms)]
            detail = (f"; tiles kept {min(kept):.4f}-{max(kept):.4f}, "
                      f"split {min(splits)}-{max(splits)} (S "
                      f"{doms[0].nbr2.shape[0]}, ng max "
                      f"{max(d.ng_max for d in doms)})")
        _say(f"{name} ({what}, {x.shape[0]:,} atoms, "
             f"{runner.mesh.placement()}): unique pairs in cut-off "
             f"{n_pairs}{detail}; F rel {f_rel:.2e}, E rel {e_rel:.2e} -> "
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
    _say("main path under DD, where the time goes:")
    _profile_window(dd, st, 2 * params.nstlist, ms_step)
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


def phase_dd_big(device, smi, timer):
    """Phase 15: 81,002 atoms, single-domain and DD, from the lattice
    start with the equilibration parameters; the gather kernel at this
    size first (_gather_row).  Returns the gather's row, its launches
    those of the single-domain run."""
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    from gromacs_fep_gpu_tpu_torch.models.solvation import solvation_system
    from gromacs_fep_gpu_tpu_torch.ops import pme, pme_kernels
    from gromacs_fep_gpu_tpu_torch.ops.forces import get_beta
    system, state = solvation_system(n_side=N_SIDE_BIG, seed=0,
                                     device=device)
    state = _decoupled(state)
    params = _params(mts=False, n_side=N_SIDE_BIG).replace(
        dt=0.0005, tau_t=0.1, nsttcouple=1)
    _say(f"81k system: {system.n_atoms} atoms, box "
         f"{float(state.box[0, 0]):.2f} nm, PME grid {params.pme_grid}")
    K = tuple(params.pme_grid)
    lam_c = float(state.lam[2])
    q = ((1.0 - lam_c) * system.charge_a + lam_c * system.charge_b
         ).contiguous()
    _, phi = pme.energy_and_potential(
        pme_kernels.spread_plain(state.x, state.box, q, K), state.box,
        get_beta(params), pme.influence_tensors(
            pme.make_influence_function(K, 4), state.x.device))
    row = _gather_row("pme_gather_big", state.x, state.box, q, phi, K,
                      timer, "gromacs_fep_gpu_tpu/ops/pme_blocked.py:447")
    kw = dict(super_nnbr=448, fep_max_nbr=512, seed=8)
    single = MdRunner(system, params, RunnerConfig(**kw))
    dd = _dd_runner(system, params, _dd_mesh(), **kw)
    _dd_force_check(single, dd, state, f"{system.n_atoms:,} atoms, lattice "
                    "start")
    for name, r in (("single-domain", single), ("DD", dd)):
        st, lg, sec, counts = _drive(r, state, BIG_STEPS,
                                     f"{system.n_atoms:,} atoms, {name}")
        on = torch.isfinite(lg.epot)
        row["launches" if r is single else "launches_dd"] = \
            counts["pme_gather_big"]
        _say(f"{system.n_atoms:,} atoms, {name}: {BIG_STEPS} steps (dt 0.5 "
             f"fs), {sec / BIG_STEPS * 1e3:.3f} ms/step on {smi}; regrows "
             f"{r.n_regrow} "
             f"(super_nnbr {r.config.super_nnbr}, baked shifts "
             f"{r.config.baked_shifts}); flags {r.last_flags}; Epot "
             f"{[round(float(e), 1) for e in lg.epot[on]]}; T "
             f"{float(lg.temp[-1]):.1f} K; NB launches "
             f"{ {k: v for k, v in counts.items() if k.startswith('nb_') and v} }")
    return row


def _cli(argv, device):
    """cli.main(argv) on its default device, the card (device "cuda"), or
    on `device` for a rehearsal on the CPU; returns (what the command
    returns, its standard output)."""
    import contextlib
    import io
    from gromacs_fep_gpu_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = (cli.main(argv) if device == "cuda"
               else cli.main(argv, device=device))
    return out, buf.getvalue()


def _cli_perf(text):
    """(ns/day, ms/step) of the CLI's performance line."""
    m = re.search(r"Performance:\s+([\d.]+) ns/day\s+([\d.]+) ms/step",
                  text)
    return float(m.group(1)), float(m.group(2))


def _cli_outputs(deffnm, runner, step0, nsteps):
    """Check one mdrun's files: ener.csv (Epot finite on exactly the
    nstcalcenergy steps, the rest of the row finite), dhdl.xvg (Delta H
    finite, on exactly the nstdhdl steps), the .edr read back (its energies
    equal to ener.csv at rel 1e-5, its Delta H blocks on the nstdhdl
    frames) and the .gmx.cpt read back; returns ener.csv's rows."""
    from gromacs_fep_gpu_tpu_torch.io.cptio import read_gmx_cpt
    from gromacs_fep_gpu_tpu_torch.io.edrio import ENX_DH, read_edr
    from gromacs_fep_gpu_tpu_torch.io.xvgio import read_xvg
    p = runner.params
    steps = step0 + np.arange(nsteps)
    ener = np.loadtxt(f"{deffnm}.ener.csv", ndmin=2)
    if ener.shape != (nsteps, 5):
        raise AssertionError(f"{deffnm}.ener.csv: shape {ener.shape}")
    on = np.isfinite(ener[:, 1])
    if not (np.array_equal(on, steps % p.nstcalcenergy == 0)
            and np.isfinite(ener[:, [0, 2, 3, 4]]).all()):
        raise AssertionError(f"{deffnm}.ener.csv: non-finite values")
    dh_steps = steps[steps % p.fep.nstdhdl == 0]
    data, _ = read_xvg(f"{deffnm}.dhdl.xvg")
    data = data.reshape(len(dh_steps), -1) if data.size else np.zeros((0, 1))
    if not (np.allclose(data[:, 0], dh_steps * p.dt)
            and np.isfinite(data).all()):
        raise AssertionError(f"{deffnm}.dhdl.xvg: rows at "
                             f"{data[:, 0]} ps, expected {dh_steps * p.dt}")
    names, _, frames = read_edr(f"{deffnm}.edr")
    e = np.array([f.ener for f in frames])
    if ([f.step for f in frames] != list(steps)
            or [f.step for f in frames
                if any(b.id == ENX_DH for b in f.blocks)] != list(dh_steps)):
        raise AssertionError(f"{deffnm}.edr: frames or Delta H blocks")
    np.testing.assert_allclose(e[:, [0, 1, 3, 4]], ener[:, 1:], rtol=1e-5,
                               equal_nan=True)
    cp = read_gmx_cpt(f"{deffnm}.gmx.cpt")
    if cp.step != step0 + nsteps or cp.natoms != runner.system.n_atoms:
        raise AssertionError(f"{deffnm}.gmx.cpt: step {cp.step}")
    return ener


def phase_cli(device, smi, ms_main, box=CLI_BOX, eq_steps=CLI_EQ_STEPS,
              win_steps=CLI_WINDOW_STEPS, ex_steps=EXAMPLE_STEPS,
              counted=True, em_steps=EM_STEPS):
    """Phase 16: the port's CLI (cli.main, in-process, default device) in a
    temporary directory, the inputs written from Python:
    (a) examples/solvation_fep.sh as published (solvate, 5 x grompp +
        mdrun, bar and bar -method mbar), then window 0 with combination
        rule 3 and -fep gpu (K1's in-loop minimum image on the 1.24 nm box,
        launches exact);
    (b) the same topology (rule 3) solvated at `box` with the main path's
        physics in mdp form (pme_mdp), minimized first (e1): an
        equilibration from em.gro (dt 1 fs, tau-t 0.1 ps, gen-vel), then
        windows 1 and 2 from its .cpt, launches exact, T in TEMP_BAND on
        every step, no overflow left, outputs read back (_cli_outputs),
        trajectories (e2), bar over the 1 -> 2 leg;
    (c) -fep gpu against -fep cpu from one run input (the equilibrated
        frame), one step each: energies rel 1e-4, the dhdl.xvg row 1e-4 of
        its largest entry;
    (d) -cpi x.cpt -nsteps 20 restores the state exactly and continues
        the step count; 20 + 20 steps against 40 in one run: max |dx|
        printed beside the 1e-5 nm gate and beside two uninterrupted runs'
        spread (the card's runs are not bitwise reproducible), and held to
        the larger of 1e-5 nm and 3 x that spread;
    (e) a lambda window's whole chain (_cli_minimize, _cli_frames,
        _cli_rerun): (e1) steep (em_steps, emtol EM_TOL, -fep gpu) on the
        freshly solvated box, (e2) trr (x, v every CLI_NSTXOUT) and xtc
        (every CLI_NSTXTC) frames of windows 1 and 2, (e3) mdrun -rerun of
        window 1's trr and xtc against its dhdl.xvg.
    counted=False (a CPU rehearsal: plain versions count no launch) skips
    the launch checks.  Returns the launches of the minimization."""
    t_start = time.perf_counter()
    lig, top_t, mdp_t, n_win = example_inputs()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            em_counts = _cli_phase_body(device, smi, ms_main, box, eq_steps,
                                        win_steps, ex_steps, counted, lig,
                                        top_t, mdp_t, n_win, em_steps)
        finally:
            os.chdir(cwd)
    _say(f"CLI phase: {time.perf_counter() - t_start:.1f} s on {smi}")
    return em_counts


def _cli_mdrun(argv, device, counted, step0, nsteps, what):
    """One mdrun with the counters zeroed just before and read just after;
    the launches must be what the flavour pattern predicts."""
    if device == "cuda":
        torch.cuda.synchronize()
    _zero_counts()
    (runner, state), out = _cli(["mdrun"] + argv, device)
    counts = _counts()
    expected = _expected_counts(runner, step0, nsteps) if counted else None
    if counted and counts != expected:
        raise AssertionError(f"{what}: launches {counts}, expected "
                             f"{expected}")
    fl = runner.last_flags
    left = {k: fl[k] for k in ("fep_ovf", "s_ovf", "n_ovf", "excl_bad",
                               "shift_bad", "t_ovf", "halo_bad")}
    if any(left.values()):
        raise AssertionError(f"{what}: list flags after growth {left}")
    if state.step != step0 + nsteps:
        raise AssertionError(f"{what}: ended at step {state.step}")
    nb = {k: v for k, v in counts.items() if v}
    return runner, state, out, nb


def _cli_phase_body(device, smi, ms_main, box, eq_steps, win_steps,
                    ex_steps, counted, lig, top_t, mdp_t, n_win, em_steps):
    from gromacs_fep_gpu_tpu_torch.io.xvgio import read_xvg

    def write(path, text):
        with open(path, "w") as f:
            f.write(text)

    def grompp(mdp, top, conf, tpz):
        _cli(["grompp", "-f", mdp, "-p", top, "-c", conf, "-o", tpz], device)

    # (a) the example as published
    write("lig.gro", lig)
    _, out = _cli(["solvate", "-cp", "lig.gro", "-box", str(EXAMPLE_BOX),
                   "-o", "conf.gro"], device)
    nsol = int(re.search(r"added (\d+)", out).group(1))
    write("topol.top", top_t.format(nsol=nsol))
    xvgs, layouts = [], set()
    for w in range(n_win):
        write(f"md{w}.mdp", mdp_t.format(nsteps=ex_steps, window=w))
        grompp(f"md{w}.mdp", "topol.top", "conf.gro", f"w{w}.tpz")
        runner, _, _, _ = _cli_mdrun(["-s", f"w{w}.tpz", "-deffnm", f"w{w}"],
                                     device, counted, 0, ex_steps,
                                     f"example window {w}")
        _cli_outputs(f"w{w}", runner, 0, ex_steps)
        layouts.add(runner.layout)
        xvgs.append(f"w{w}.dhdl.xvg")
    (dg_bar, e_bar), _ = _cli(["bar", "-f"] + xvgs, device)
    (dg_mbar, e_mbar), _ = _cli(["bar", "-f"] + xvgs + ["-method", "mbar"],
                                device)
    if not (np.isfinite(dg_bar) and np.isfinite(dg_mbar)):
        raise AssertionError(f"example: BAR {dg_bar}, MBAR {dg_mbar}")
    _say(f"CLI (a) examples/solvation_fep.sh as published: LIG + {nsol} "
         f"SOL ({3 * nsol + 1} atoms, box {EXAMPLE_BOX} nm, reaction "
         f"field), {n_win} windows x {ex_steps} steps, NB route "
         f"{sorted(layouts)} (combination rule 2 demotes -fep auto to the "
         f"table route); dG(vdW decoupling) BAR {dg_bar:.3f} +- "
         f"{e_bar:.3f} kJ/mol, MBAR {dg_mbar:.3f} +- {e_mbar:.3f} kJ/mol; "
         f"{smi}")
    write("topol3.top", geometric_top(top_t).format(nsol=nsol))
    grompp("md0.mdp", "topol3.top", "conf.gro", "g0.tpz")
    runner, _, out, nb = _cli_mdrun(
        ["-s", "g0.tpz", "-deffnm", "g0", "-fep", "gpu"], device, counted,
        0, ex_steps, "example window 0, rule 3, -fep gpu")
    _cli_outputs("g0", runner, 0, ex_steps)
    if runner.layout != "v2u" or runner.config.baked_shifts:
        raise AssertionError(f"rule 3 -fep gpu: layout {runner.layout}, "
                             f"baked shifts {runner.config.baked_shifts}")
    _say(f"CLI (a) window 0 with combination rule 3, -fep gpu: K1 with the "
         f"in-loop minimum image (baked shifts off), launches {nb}; "
         f"{_cli_perf(out)[1]:.3f} ms/step on {smi}")

    # (b) the main path's size and physics through grompp and mdrun
    _, out = _cli(["solvate", "-cp", "lig.gro", "-box", str(box), "-o",
                   "big.gro"], device)
    nsol = int(re.search(r"added (\d+)", out).group(1))
    write("big.top", geometric_top(top_t).format(nsol=nsol))
    w1, w2 = CLI_WINDOWS
    # (e1) minimize the freshly solvated box; the equilibration starts
    # from em.gro, as a user's chain does
    write("em.mdp", mdp_with(pme_mdp(mdp_t.format(nsteps=em_steps,
                                                  window=w1)),
                             {"integrator": "steep", "emtol": EM_TOL,
                              "mts": "no"}))
    grompp("em.mdp", "big.top", "big.gro", "em.tpz")
    em_counts, e_seconds = _cli_minimize(device, smi, counted)
    write("eq.mdp", mdp_with(pme_mdp(mdp_t.format(nsteps=eq_steps,
                                                  window=w1)),
                             {"dt": EQ_DT, "tau-t": 0.1, "nsttcouple": 1,
                              "mts": "no"}))
    grompp("eq.mdp", "big.top", "em.gro", "eq.tpz")
    runner, _, out, nb = _cli_mdrun(["-s", "eq.tpz", "-deffnm", "eq"],
                                    device, counted, 0, eq_steps,
                                    "CLI equilibration")
    eq_ener = _cli_outputs("eq", runner, 0, eq_steps)
    grid = runner.params.pme_grid
    if box == CLI_BOX and tuple(grid) != (42, 42, 42):
        raise AssertionError(f"PME grid {grid} at box {box}")
    _say(f"CLI (b) LIG + {nsol} SOL = {runner.system.n_atoms} atoms, box "
         f"{box} nm, PME grid {tuple(grid)} (gromacs_pme_grid at "
         f"fourier-spacing 0.12), layout {runner.layout}; equilibration "
         f"{eq_steps} steps at dt {EQ_DT * 1e3:g} fs: T every 100 steps "
         f"{[round(float(t), 1) for t in eq_ener[::100, 3]]} K, "
         f"{_cli_perf(out)[1]:.3f} ms/step, launches {nb}; {smi}")
    xvgs = []
    for w in CLI_WINDOWS:
        write(f"win{w}.mdp", mdp_with(
            pme_mdp(mdp_t.format(nsteps=win_steps, window=w)),
            {"nstxout": CLI_NSTXOUT, "nstvout": CLI_NSTXOUT,
             "nstxout-compressed": CLI_NSTXTC}))
        grompp(f"win{w}.mdp", "big.top", "big.gro", f"win{w}.tpz")
        runner, state, out, nb = _cli_mdrun(
            ["-s", f"win{w}.tpz", "-cpi", "eq.cpt", "-deffnm", f"win{w}"],
            device, counted, eq_steps, win_steps, f"CLI window {w}")
        ener = _cli_outputs(f"win{w}", runner, eq_steps, win_steps)
        t_lo, t_hi = float(ener[:, 3].min()), float(ener[:, 3].max())
        if not (TEMP_BAND[0] <= t_lo and t_hi <= TEMP_BAND[1]):
            raise AssertionError(f"CLI window {w}: temperature left "
                                 f"{TEMP_BAND} K: {t_lo:.1f}..{t_hi:.1f}")
        ns_day, ms = _cli_perf(out)
        _say(f"CLI (b) window {w} (MTS2, dt 2 fs, {win_steps} steps from "
             f"eq.cpt): {ms:.3f} ms/step, {ns_day:.3f} ns/day by the CLI's "
             f"performance line against MdRunner's {ms_main:.3f} ms/step "
             f"(phase 5, 12,290 atoms) in this call; T {t_lo:.1f}.."
             f"{t_hi:.1f} K; launches {nb}; layout {runner.layout}; {smi}")
        e_seconds += _cli_frames(f"win{w}", state, eq_steps, win_steps, out,
                                 smi)
        xvgs.append(f"win{w}.dhdl.xvg")
    (dg, err), out = _cli(["bar", "-f"] + xvgs, device)
    leg = re.search(rf"\n\s*{w1} -> {w2}\s+(\S+)\s+(\S+)", out)
    if not np.isfinite(float(leg.group(1))):
        raise AssertionError(f"bar over {w1} -> {w2}: {out}")
    _say(f"CLI (b) bar over the {w1} -> {w2} leg: {leg.group(1)} +- "
         f"{leg.group(2)} kJ/mol")
    e_seconds += _cli_rerun(device, w1)
    _say(f"CLI (e) a window's chain (minimization, frames written, rerun): "
         f"{e_seconds:.1f} s on {smi}")

    # (c) -fep gpu against -fep cpu from one run input
    write("one.mdp", pme_mdp(mdp_t.format(nsteps=1, window=w1)))
    grompp("one.mdp", "big.top", "eq.gro", "one.tpz")
    rows = {}
    for fep in ("gpu", "cpu"):
        runner, _, _, nb = _cli_mdrun(
            ["-s", "one.tpz", "-deffnm", f"one_{fep}", "-fep", fep],
            device, counted, 0, 1, f"-fep {fep}")
        rows[fep] = (np.loadtxt(f"one_{fep}.ener.csv"),
                     read_xvg(f"one_{fep}.dhdl.xvg")[0].reshape(-1),
                     runner.layout, nb)
    e_rel = float(np.max(np.abs(rows["gpu"][0] - rows["cpu"][0])
                         / np.maximum(np.abs(rows["cpu"][0]), 1e-30)))
    d_gpu, d_cpu = rows["gpu"][1][1:], rows["cpu"][1][1:]
    d_rel = float(np.abs(d_gpu - d_cpu).max() / np.abs(d_cpu).max())
    _say(f"CLI (c) -fep gpu ({rows['gpu'][2]}, {rows['gpu'][3]}) against "
         f"-fep cpu ({rows['cpu'][2]}, {rows['cpu'][3]}), step 0 of the "
         f"equilibrated frame: energies rel {e_rel:.2e} (gate 1e-4), dhdl "
         f"row {d_rel:.2e} of its largest entry (gate 1e-4)")
    if rows["gpu"][2] == rows["cpu"][2] or e_rel > 1e-4 or d_rel > 1e-4:
        raise AssertionError("-fep gpu against -fep cpu")

    # (d) restart: 20 + 20 steps against 40
    _cli_restart(device, counted, f"win{w1}.tpz", "eq.cpt", eq_steps,
                 CLI_RESTART_STEPS, "CLI (d)")
    return em_counts


def _settle_deviation(system, x, box):
    """max |r - d| / d over every SETTLE water's two O-H and its H-H
    distance (minimum image)."""
    from gromacs_fep_gpu_tpu_torch.core.pbc import pbc_dx
    st = system.settle
    o, h1, h2 = (x[st.atoms[:, i]] for i in range(3))
    dev = torch.zeros((), dtype=x.dtype, device=x.device)
    for a, b, d in ((o, h1, st.d_oh), (o, h2, st.d_oh), (h1, h2, st.d_hh)):
        r = torch.linalg.norm(pbc_dx(a - b, box), dim=-1)
        dev = torch.maximum(dev, ((r - d).abs() / d).max())
    return float(dev)


def _cli_minimize(device, smi, counted):
    """(e1): mdrun of em.tpz (steep, -fep gpu) with the counters zeroed
    just before and read just after: one K1 VF, one spread and one gather
    per force call and nothing else; Epot lower at the end than at the
    start, each accepted step lower than the one before, a rejected one
    equal; every SETTLE water within SETTLE_DEV of its geometry; the first
    force call (at the constrained start) against the CPU's plain versions
    on the same frame, E rel 1e-4, F rel 5e-4; ms per EM step (the CLI's
    line: host clock, ending in torch.cuda.synchronize()) and kernels per
    EM step (torch.profiler over EM_PROFILE_STEPS more steps).  Returns
    (the launches, the seconds of the mdrun call)."""
    from gromacs_fep_gpu_tpu_torch import cli
    from gromacs_fep_gpu_tpu_torch.md.minimize import steepest_descent
    from gromacs_fep_gpu_tpu_torch.md.runner import MdRunner, RunnerConfig
    if device == "cuda":
        torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    (runner, res), out = _cli(["mdrun", "-s", "em.tpz", "-deffnm", "em",
                               "-fep", "gpu"], device)
    counts = _counts()
    seconds = time.perf_counter() - t0
    calls = int(re.search(r"\((\d+) force calls", out).group(1))
    broken = int(re.search(r"(\d+) trials whose constraints failed",
                           out).group(1))
    ms_em = float(re.search(r"([\d.]+) ms per EM step", out).group(1))
    trace = res.epot_trace.double().cpu().numpy()
    acc = res.accepted.cpu().numpy()
    drop = np.diff(trace)
    if not (trace[-1] < trace[0] and (drop[acc] < 0).all()
            and (drop[~acc] == 0).all() and calls == res.n_steps + 1):
        raise AssertionError(f"EM: Epot {trace}, accepted {acc}, {calls} "
                             f"force calls for {res.n_steps} steps")
    nb = {k: v for k, v in counts.items() if v}
    if counted:
        sfx = _pme_suffix(runner.params.pme_grid)
        expected = dict.fromkeys(_nb_counts(), 0)
        expected.update(dict.fromkeys(PME_KEYS, 0))
        expected.update({"nb_v2u_VF": calls, "pme_spread" + sfx: calls,
                         "pme_gather" + sfx: calls})
        if counts != expected:
            raise AssertionError(f"EM: launches {counts}, expected "
                                 f"{expected}")
    pp, _ = cli._load_tpz("em.tpz", device)
    box, lam = pp.state.box, pp.state.lam
    dev = _settle_deviation(runner.system, res.x, box)
    if not dev <= SETTLE_DEV:
        raise AssertionError(f"EM: SETTLE max |r - d| / d {dev:.2e}")
    # the first force call on the card against the CPU's plain versions
    force, cons, _, _ = cli.em_functions(runner, pp.state)
    x0 = pp.state.x if cons is None else cons(pp.state.x, pp.state.x)
    f_g, t_g = force(x0, box, lam)
    pc, _ = cli._load_tpz("em.tpz", "cpu")
    cpu = MdRunner(pc.system, runner.params,
                   RunnerConfig(layout=runner.layout))
    f_c, t_c = cli.em_functions(cpu, pc.state)[0](x0.cpu(), pc.state.box,
                                                  pc.state.lam)
    e_rel = abs(float(t_g.epot) - float(t_c.epot)) / abs(float(t_c.epot))
    f_rel, _ = _rel(f_g.cpu(), f_c)
    if not (e_rel <= 1e-4 and f_rel <= 5e-4):
        raise AssertionError(f"EM: first force call against the CPU: E rel "
                             f"{e_rel:.2e}, F rel {f_rel:.2e}")
    per = ""
    if device == "cuda":
        force, cons, valid, pcalls = cli.em_functions(runner, pp.state)
        n_kern, n_copy, _ = _device_ops(
            lambda: steepest_descent(res.x, box, lam, force,
                                     nsteps=EM_PROFILE_STEPS, emtol=0.0,
                                     step0=runner.params.emstep,
                                     constrain_fn=cons, valid_fn=valid), 1)
        per = (f"{n_kern / EM_PROFILE_STEPS:.0f} kernels and "
               f"{n_copy / EM_PROFILE_STEPS:.1f} copies per EM step "
               f"({n_kern / pcalls[0]:.0f} kernels per force call; "
               f"torch.profiler over {EM_PROFILE_STEPS} more steps), ")
    _say(f"CLI (e1) steep on the freshly solvated box "
         f"({runner.system.n_atoms} atoms, emtol {EM_TOL:g}, -fep gpu): "
         f"{res.n_steps} steps, {int(acc.sum())} accepted ({broken} "
         f"trials rejected because SETTLE broke there), Epot "
         f"{trace[0]:.1f} -> {trace[-1]:.1f} kJ/mol, Fmax "
         f"{float(res.fmax):.1f} kJ/mol/nm; {ms_em:.3f} ms per EM step "
         f"(host clock, ending in torch.cuda.synchronize()), {per}"
         f"launches {nb} for {calls} force calls; first force call against "
         f"the CPU's plain versions: E rel {e_rel:.2e} (gate 1e-4), F rel "
         f"{f_rel:.2e} (gate 5e-4); SETTLE max |r - d| / d {dev:.2e} (gate "
         f"{SETTLE_DEV:g}); {seconds:.1f} s; {smi}")
    return counts, seconds


def _cli_frames(deffnm, state, step0, nsteps, out, smi):
    """(e2): the window's trr frames at exactly the multiples of
    CLI_NSTXOUT in [step0, step0 + nsteps] and its xtc frames at those of
    CLI_NSTXTC; the last trr frame's x and v bitwise the run's final state
    and its .cpt.  Returns the seconds the CLI spent writing frames."""
    from gromacs_fep_gpu_tpu_torch.io.checkpoint import load_checkpoint
    from gromacs_fep_gpu_tpu_torch.io.trrio import read_trr_frame, scan_trr
    from gromacs_fep_gpu_tpu_torch.io.xtcio import read_xtc_frame, scan_xtc
    steps = range(step0, step0 + nsteps + 1)
    got = {}
    for kind, n, scan, read in (("trr", CLI_NSTXOUT, scan_trr,
                                 read_trr_frame),
                                ("xtc", CLI_NSTXTC, scan_xtc,
                                 read_xtc_frame)):
        na, nf = scan(f"{deffnm}.{kind}")
        frames = [read(f"{deffnm}.{kind}", i, na) for i in range(nf)]
        want = [s for s in steps if s % n == 0]
        if [fr["step"] for fr in frames] != want:
            raise AssertionError(f"{deffnm}.{kind}: frames at "
                                 f"{[fr['step'] for fr in frames]}, expected "
                                 f"{want}")
        got[kind] = frames
    last = got["trr"][-1]
    cpt = load_checkpoint(f"{deffnm}.cpt", "cpu")
    # the frame steps are exact, so the last frame is the final state's
    # step when that step is a multiple of CLI_NSTXOUT (on the card)
    for k in ("x", "v") if last["step"] == state.step else ():
        if not (np.array_equal(last[k], getattr(state, k).cpu().numpy())
                and np.array_equal(last[k], getattr(cpt, k).numpy())):
            raise AssertionError(f"{deffnm}.trr: the last frame's {k} is "
                                 "not the final state's")
    same = [fr for fr in got["xtc"] if fr["step"] == last["step"]]
    dx = float(np.abs(same[0]["x"] - last["x"]).max())
    ms = float(re.search(r"; ([\d.]+) ms per frame written", out).group(1))
    n = len(got["trr"]) + len(got["xtc"])
    _say(f"CLI (e2) {deffnm}: {len(got['trr'])} trr frames (x, v) at steps "
         f"{[fr['step'] for fr in got['trr']]}, {len(got['xtc'])} xtc frames "
         f"every {CLI_NSTXTC} steps; the last trr frame (step "
         f"{last['step']}) against the final state (step {state.step}) and "
         f".cpt: bitwise where the steps agree, the xtc frame of the same "
         f"step within {dx:.2e} nm of it "
         f"(precision 1e-3 nm); {ms:.3f} ms per frame written (host clock, "
         f"the copy from the device included); {smi}")
    return ms * n / 1e3


def _cli_rerun(device, w):
    """(e3): mdrun -rerun of window w's trr reproduces its dhdl.xvg rows
    (dH/dlambda and Delta H) at the frame steps to rel 1e-4 of the largest
    entry; the rerun of its xtc is printed beside the xtc's 1e-3 nm
    precision.  Returns the seconds of both reruns."""
    from gromacs_fep_gpu_tpu_torch.io.xvgio import read_xvg
    t0 = time.perf_counter()
    run_rows = read_xvg(f"win{w}.dhdl.xvg")[0]
    rel = {}
    for kind in ("trr", "xtc"):
        (_, frames), _ = _cli(["mdrun", "-s", f"win{w}.tpz", "-rerun",
                               f"win{w}.{kind}", "-deffnm", f"rerun_{kind}"],
                              device)
        rows = read_xvg(f"rerun_{kind}.dhdl.xvg")[0]
        t_run, t_rerun = np.round(run_rows[:, 0], 6), np.round(rows[:, 0], 6)
        both = np.intersect1d(t_run, t_rerun)
        a = run_rows[np.isin(t_run, both)]
        b = rows[np.isin(t_rerun, both)]
        if len(a) == 0 or len(a) != len(b) or len(rows) != len(frames.step):
            raise AssertionError(f"rerun of win{w}.{kind}: rows at "
                                 f"{rows[:, 0]} against {run_rows[:, 0]}")
        rel[kind] = (float(np.abs(a[:, 1:] - b[:, 1:]).max()
                           / np.abs(a[:, 1:]).max()), len(a), len(rows))
    seconds = time.perf_counter() - t0
    _say(f"CLI (e3) mdrun -rerun win{w}.trr ({rel['trr'][2]} frames): the "
         f"window's dhdl.xvg rows at the {rel['trr'][1]} frame steps within "
         f"{rel['trr'][0]:.2e} of the largest entry (gate 1e-4); of "
         f"win{w}.xtc ({rel['xtc'][2]} frames, 1e-3 nm precision): "
         f"{rel['xtc'][0]:.2e} over {rel['xtc'][1]} rows; {seconds:.1f} s")
    if not rel["trr"][0] <= 1e-4:
        raise AssertionError(f"rerun of win{w}.trr: rel {rel['trr'][0]}")
    return seconds


def _cli_restart(device, counted, tpz, cpt, step0, n, what):
    """-cpi `cpt` -nsteps n restores the state exactly and continues the
    step count; n + n steps against 2n in one run.  The card's runs are
    not bitwise reproducible (the spread's atomics, autograd's scatters),
    so a second uninterrupted run from the same checkpoint measures the
    spread the restart is held to: max |dx| at most the larger of 1e-5 nm
    and 3 x that spread."""
    from gromacs_fep_gpu_tpu_torch import cli
    whole = []
    for tag in ("r40", "r40b"):
        _, st, _, _ = _cli_mdrun(["-s", tpz, "-cpi", cpt, "-nsteps",
                                  str(2 * n), "-deffnm", tag], device,
                                 counted, step0, 2 * n, f"restart, {tag}")
        whole.append(st)
    runner, half, _, _ = _cli_mdrun(
        ["-s", tpz, "-cpi", cpt, "-nsteps", str(n), "-deffnm", "r20"],
        device, counted, step0, n, "restart, first 20")
    back = cli._restore(types.SimpleNamespace(cpi="r20.cpt"),
                        half.replace(step=0), runner, runner.params, device)
    for k in ("x", "v", "box", "lam"):
        if not torch.equal(getattr(back, k), getattr(half, k)):
            raise AssertionError(f"restart: {k} not restored exactly")
    if back.step != half.step or not torch.equal(
            back.coupling.ekinh_prev, half.coupling.ekinh_prev):
        raise AssertionError("restart: step or thermostat not restored")
    runner, rest, _, _ = _cli_mdrun(
        ["-s", tpz, "-cpi", "r20.cpt", "-nsteps", str(n), "-deffnm",
         "r20b"], device, counted, step0 + n, n, "restart, next 20")
    _cli_outputs("r20b", runner, step0 + n, n)
    dx = float((rest.x - whole[0].x).abs().max())
    noise = float((whole[1].x - whole[0].x).abs().max())
    _say(f"{what} -cpi r20.cpt -nsteps {n} ({runner.params.integrator.value})"
         f": steps {step0 + n}..{rest.step}, state restored exactly; final "
         f"positions against {2 * n} steps in one run: max |dx| {dx:.2e} nm "
         f"(1e-5 gate {'met' if dx <= 1e-5 else 'missed'}); two "
         f"uninterrupted {2 * n}-step runs from one checkpoint differ by "
         f"{noise:.2e} nm")
    if dx > max(1e-5, 3.0 * noise):
        raise AssertionError(f"restart: max |dx| {dx} nm, uninterrupted "
                             f"runs {noise} nm apart")


def phase_ethanol(device, smi, ms_main, box=ETH_BOX, eq_steps=ETH_EQ_STEPS,
                  win_steps=ETH_WINDOW_STEPS, counted=True):
    """Phase 17: a user's OPLS-AA ligand (ETH_TOP: RB dihedrals from
    [ dihedraltypes ], a perturbed dihedral, a dihedral restraint, a
    flat-bottomed position restraint under -DPOSRES) decoupled in water
    under sd, through the port's CLI in a temporary directory: solvate at
    `box`, grompp -r, mdrun -fep gpu (K1, and K2/K3 on PME), bar.
    An equilibration (tau-t ETH_EQ_TAU_T, gen-vel), then windows 1 and 2
    from its .cpt (tau-t 1 ps) with (c) each window's mean T in
    ETH_T_MEAN_BAND, (d) exact launches and (e) ms/step and ns/day by the
    CLI's performance line and kernels per step (torch.profiler over a
    fresh 40-step window); on the equilibrated frame (a) each listed
    term's energy, forces and dV/dlambda (7,) on the card against the CPU
    (E rel 1e-4 of max(|E|, 1e-3 kJ/mol), F 5e-4 of max |F|, dV/dlambda
    1e-4 of max(|dV/dlambda|, |E|, 1e-3)) and (b) each Delta H column of the
    sweep against the difference of two single e_lambda calls (1e-4 of
    max(|Delta H|, 1e-3 kJ/mol)); (f) the 20 + 20 restart under sd
    (_cli_restart); (g) BAR (the CLI) and MBAR over the 1 -> 2 leg,
    finite and within their errors of each other; (h) the LINCS rows'
    largest |r - d| / d after the equilibration and each window at most
    LINCS_DEV, and on the equilibrated frame SETTLE + LINCS with the
    O-HO row's B length set to ETH_OHO_LEN_B on the card against the CPU
    (_ethanol_lincs_check).  counted=False (a CPU rehearsal) skips the
    launch checks, the profile and the constraint layer's timing."""
    t_start = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            _ethanol_body(device, smi, ms_main, box, eq_steps, win_steps,
                          counted)
        finally:
            os.chdir(cwd)
    _say(f"ethanol phase: {time.perf_counter() - t_start:.1f} s on {smi}")


def _ethanol_term_checks(runner, state):
    """(a): each listed term on the card against the CPU at the run's
    lambda vector, on the frame and on the frame displaced by seeded
    0.03 nm noise (a flat-bottomed term at rest on one of them is off it
    on the other); returns the printed rows."""
    from gromacs_fep_gpu_tpu_torch.core.types import InteractionList
    from gromacs_fep_gpu_tpu_torch.ops import bonded

    def term(name, il, x0, dev):
        il = InteractionList(*(getattr(il, f).to(dev) for f in
                               ("atoms", "params_a", "params_b", "mask")))
        x = x0.detach().to(dev).requires_grad_(True)
        lam = state.lam.detach().to(dev).requires_grad_(True)
        with torch.enable_grad():
            e = bonded.listed_energy(name, x, state.box.to(dev), il, lam,
                                     runner.params.disre_fc)
            gx, gl = torch.autograd.grad(e, [x, lam], allow_unused=True)
        gl = torch.zeros_like(lam) if gl is None else gl
        return e.detach().cpu(), -gx.cpu(), gl.cpu()

    noise = 0.03 * torch.randn(state.x.shape,
                               generator=torch.Generator().manual_seed(17))
    frames = (("frame", state.x),
              ("displaced", state.x + noise.to(state.x.device)))
    rows = []
    for what, x0 in frames:
        for name, il in runner.system.bonded.items():
            (e_g, f_g, d_g), (e_c, f_c, d_c) = (
                term(name, il, x0, d) for d in (state.x.device, "cpu"))
            e_rel = float((e_g - e_c).abs()) / max(float(e_c.abs()), 1e-3)
            f_rel = (_rel(f_g, f_c)[0] if float(f_c.abs().max()) > 0
                     else float(f_g.abs().max()))
            # dV/dlambda = E_B - E_A for terms linear in their parameters:
            # its float32 rounding scales with the energies, not with the
            # difference (a perturbed RB dihedral near its minimum gives
            # -0.005 kJ/mol out of terms of ~4)
            d_rel = float((d_g - d_c).abs().max()) / max(
                float(d_c.abs().max()), float(e_c.abs()), 1e-3)
            comp = int(d_c.abs().argmax())
            rows.append(f"{name} (n {il.n}, {what}): E {float(e_c):.5f} "
                        f"kJ/mol rel {e_rel:.1e}, F rel {f_rel:.1e}, "
                        f"dV/dl[{comp}] {float(d_c[comp]):.5f} rel "
                        f"{d_rel:.1e}")
            if e_rel > 1e-4 or f_rel > 5e-4 or d_rel > 1e-4:
                raise AssertionError(f"(a) {rows[-1]}")
    return rows


def _constraint_deviation(system, state):
    """max |r - d| / d over the LINCS rows of `state`, d the lengths at the
    state's lambda_bonded; raises above LINCS_DEV."""
    lc = system.lincs
    lam_b = state.lam[4]
    d = (1.0 - lam_b) * lc.length_a + lam_b * lc.length_b
    r = torch.linalg.norm(state.x[lc.atoms[:, 0]] - state.x[lc.atoms[:, 1]],
                          dim=-1)
    dev = float(((r - d).abs() / d).max())
    if not dev <= LINCS_DEV:
        raise AssertionError(f"LINCS rows: max |r - d| / d {dev:.2e}")
    return dev


def _ethanol_lincs_check(runner, state, counted):
    """(h): SETTLE + LINCS (md/constraints.constrain with_dhdl, the
    runner's lincs-order and lincs-iter) of x + dt v on the card against
    the CPU, for a copy of the system whose O-HO row has the B length
    ETH_OHO_LEN_B, at the state's lambda_bonded: positions within 5e-6
    nm, the constraint dV/dlambda within rel 1e-4.  With counted, the
    constraint layer's time per call (CUDA events around the call, as the
    layers of phase_profile) and its kernels per call (torch.profiler).
    Returns the printed line."""
    from gromacs_fep_gpu_tpu_torch.core.types import (LincsConstraints,
                                                       SettleGroups)
    from gromacs_fep_gpu_tpu_torch.md import constraints as constr
    from gromacs_fep_gpu_tpu_torch.md.simulator import masses_at_lambda
    p, lc, st = runner.params, runner.system.lincs, runner.system.settle
    oho = [k for k, (i, j) in enumerate(lc.atoms.tolist()) if (i, j) == (7, 8)]
    if len(oho) != 1:
        raise AssertionError(f"(h) no O-HO row in {lc.atoms.tolist()}")
    len_b = lc.length_b.clone()
    len_b[oho[0]] = ETH_OHO_LEN_B
    _, invm0 = masses_at_lambda(runner.system, state.lam[1])
    out = {}
    for dev in (state.x.device, torch.device("cpu")):
        sysd = types.SimpleNamespace(
            settle=SettleGroups(st.atoms.to(dev), st.d_oh.to(dev),
                                st.d_hh.to(dev), st.mask.to(dev)),
            lincs=LincsConstraints(lc.atoms.to(dev), lc.length_a.to(dev),
                                   len_b.to(dev), lc.mask.to(dev)))
        lam, invm = state.lam.to(dev), invm0.to(dev)
        x0, box = state.x.to(dev), state.box.to(dev)
        x1 = x0 + p.dt * state.v.to(dev)

        call = functools.partial(constr.constrain, x0, x1, box, sysd, invm,
                                 lam[4], p.lincs_order, p.lincs_iter,
                                 with_dhdl=True)
        xc, dhdl_dt2 = call()
        out[dev.type] = (xc.cpu(), float(dhdl_dt2) / p.dt ** 2, call,
                         (x0, x1, box, sysd.lincs, invm, lam[4]))
    (xg, dg, call, args), (xc, dc, _, _) = out[state.x.device.type], \
        out["cpu"]
    dx = float((xg - xc).abs().max())
    d_rel = abs(dg - dc) / max(abs(dc), 1e-30)
    line = (f"(h) SETTLE + LINCS on the card against the CPU, O-HO lenB "
            f"{ETH_OHO_LEN_B} nm at lambda_bonded {float(state.lam[4])}: "
            f"max |dx| {dx:.2e} nm (gate 5e-6), dV/dl_constr {dg:.5f} "
            f"against {dc:.5f} kJ/mol, rel {d_rel:.1e} (gate 1e-4)")
    if dx > 5e-6 or d_rel > 1e-4 or not abs(dc) > 0.0:
        raise AssertionError(line)
    if counted:
        lincs_only = functools.partial(constr.lincs_positions, *args,
                                       p.lincs_order, p.lincs_iter)
        ms_all, ms_lincs = _median_ms(call), _median_ms(lincs_only)
        k_lincs, _, _ = _device_ops(lincs_only, 1)
        k_dhdl, _, _ = _device_ops(call, 1)
        line += (f"; constraint layer at {state.x.shape[0]} atoms: LINCS "
                 f"{ms_lincs:.3f} ms in {k_lincs} kernels per call, SETTLE "
                 f"+ LINCS with dV/dl {ms_all:.3f} ms in {k_dhdl} kernels")
    return line


def _ethanol_sweep_check(runner, state):
    """(b): each Delta H column of the sweep on the card against the
    difference of two single e_lambda calls on the card; returns the
    sweep and the largest gap relative to max(|Delta H|, 1e-3)."""
    from gromacs_fep_gpu_tpu_torch.ops.foreign import make_lambda_energy_fn
    _, feplist, _, _ = runner.rebuild(state)
    e_lam = make_lambda_energy_fn(runner.system, runner.params,
                                  runner.recip_slope_fn)
    with torch.no_grad():
        dh = runner._foreign(feplist)(state.x, state.box, state.lam)
        e_cur = e_lam(state.x, state.box, state.lam, feplist)
        single = torch.stack([e_lam(state.x, state.box, lam, feplist) - e_cur
                              for lam in runner.all_lambda])
    gap = float((dh - single).abs().max()) / max(float(single.abs().max()),
                                                 1e-3)
    if gap > 1e-4 or float(dh[state.fep_state].abs()) != 0.0:
        raise AssertionError(f"(b) sweep {dh.tolist()} against single "
                             f"calls {single.tolist()}")
    return dh, gap


def _ethanol_body(device, smi, ms_main, box, eq_steps, win_steps, counted):
    from gromacs_fep_gpu_tpu_torch.analysis.mbar import mbar
    from gromacs_fep_gpu_tpu_torch.core.units import BOLTZ
    from gromacs_fep_gpu_tpu_torch.io.xvgio import read_xvg

    def write(path, text):
        with open(path, "w") as f:
            f.write(text)

    def grompp(mdp, tpz):
        _cli(["grompp", "-f", mdp, "-p", "topol.top", "-c", "conf.gro",
              "-r", "conf.gro", "-o", tpz], device)

    write("eth.gro", ETH_GRO)
    _, out = _cli(["solvate", "-cp", "eth.gro", "-box", str(box), "-o",
                   "conf.gro"], device)
    nsol = int(re.search(r"added (\d+)", out).group(1))
    write("topol.top", ETH_TOP.format(nsol=nsol))
    w1, w2 = ETH_WINDOWS
    # the windows log Delta H every 20 steps: 20 samples per window
    win_keys = {"nstcalcenergy": 20, "nstdhdl": 20}
    write("eq.mdp", mdp_with(pme_mdp(ETH_MDP.format(nsteps=eq_steps,
                                                    window=w1)),
                             {"tau-t": ETH_EQ_TAU_T}))
    grompp("eq.mdp", "eq.tpz")
    runner, eq_state, out, nb = _cli_mdrun(
        ["-s", "eq.tpz", "-deffnm", "eq", "-fep", "gpu"], device, counted,
        0, eq_steps, "ethanol equilibration")
    eq_ener = _cli_outputs("eq", runner, 0, eq_steps)
    if runner.params.integrator.value != "sd" or runner.layout != "v2u":
        raise AssertionError(f"ethanol: integrator "
                             f"{runner.params.integrator.value}, layout "
                             f"{runner.layout}")
    grid = tuple(runner.params.pme_grid)
    if box == ETH_BOX and grid != (42, 42, 42):
        raise AssertionError(f"PME grid {grid} at box {box}")
    terms = {k: v.n for k, v in runner.system.bonded.items()}
    n_lincs = runner.system.lincs.atoms.shape[0]
    dt_fs = runner.params.dt * 1e3
    if n_lincs != 6 or dt_fs != 2.0:
        raise AssertionError(f"ethanol: {n_lincs} LINCS rows at dt "
                             f"{dt_fs} fs (h-bonds: six at 2 fs)")
    dev = _constraint_deviation(runner.system, eq_state)
    _say(f"ethanol: ETH + {nsol} SOL = {runner.system.n_atoms} atoms, box "
         f"{box} nm, PME {grid}, layout {runner.layout}, listed terms "
         f"{terms}, {n_lincs} LINCS rows (h-bonds, lincs-order "
         f"{runner.params.lincs_order}, lincs-iter "
         f"{runner.params.lincs_iter}); equilibration (sd, tau-t "
         f"{ETH_EQ_TAU_T} ps, dt {dt_fs:g} fs, MTS2) {eq_steps} steps: T "
         f"every 100 steps {[round(float(t), 1) for t in eq_ener[::100, 3]]}"
         f" K, {_cli_perf(out)[1]:.3f} ms/step, launches {nb}; (h) LINCS "
         f"rows' max |r - d| / d {dev:.2e} (gate {LINCS_DEV:g}); {smi}")

    xvgs = []
    for w in ETH_WINDOWS:
        write(f"win{w}.mdp", mdp_with(pme_mdp(ETH_MDP.format(
            nsteps=win_steps, window=w)), win_keys))
        grompp(f"win{w}.mdp", f"win{w}.tpz")
        runner, state, out, nb = _cli_mdrun(
            ["-s", f"win{w}.tpz", "-cpi", "eq.cpt", "-deffnm", f"win{w}",
             "-fep", "gpu"], device, counted, eq_steps, win_steps,
            f"ethanol window {w}")
        ener = _cli_outputs(f"win{w}", runner, eq_steps, win_steps)
        t_mean = float(ener[:, 3].mean())
        ns_day, ms = _cli_perf(out)
        dev = _constraint_deviation(runner.system, state)
        _say(f"ethanol window {w} (sd, tau-t 1 ps, dt {dt_fs:g} fs, h-bonds, "
             f"MTS2, {win_steps} steps from eq.cpt): (e) {ms:.3f} ms/step, "
             f"{ns_day:.3f} ns/day by the CLI's performance line against "
             f"MdRunner's {ms_main:.3f} ms/step on the main path (phase 5) "
             f"in this call; (c) mean T {t_mean:.1f} K (band "
             f"{ETH_T_MEAN_BAND}), range {ener[:, 3].min():.1f}.."
             f"{ener[:, 3].max():.1f}; (d) launches {nb}; (h) LINCS rows' "
             f"max |r - d| / d {dev:.2e}; {smi}")
        if not ETH_T_MEAN_BAND[0] <= t_mean <= ETH_T_MEAN_BAND[1]:
            raise AssertionError(f"ethanol window {w}: mean T {t_mean:.1f}")
        xvgs.append(f"win{w}.dhdl.xvg")
        if w == w1:
            # (a) and (b) on window 1's equilibrated start frame
            st1 = eq_state.replace(lam=state.lam, fep_state=state.fep_state)
            for row in _ethanol_term_checks(runner, st1):
                _say(f"ethanol (a) {row}")
            dh, gap = _ethanol_sweep_check(runner, st1)
            _say(f"ethanol (b) the sweep at window {w} "
                 f"{[round(float(v), 4) for v in dh]} kJ/mol against "
                 f"single e_lambda calls: max gap {gap:.1e} of max |Delta "
                 f"H| (gate 1e-4)")
            _say(f"ethanol {_ethanol_lincs_check(runner, st1, counted)}; "
                 f"{smi}")
    if counted:
        # (e) kernels per step in a fresh 40-step window of the last runner
        idle, kps = _profile_window(runner, state, 2 * runner.params.nstlist,
                                    ms, top=6)
        _say(f"ethanol (e) {kps:.0f} kernels/step, idle {idle:.3f} at "
             f"{ms:.3f} ms/step, against the main path's 2,401 kernels/step "
             f"(PERF.md section 5); {smi}")

    # (g) BAR through the CLI, MBAR over the two sampled states
    (dg, err), out = _cli(["bar", "-f"] + xvgs, device)
    leg = re.search(rf"\n\s*{w1} -> {w2}\s+(\S+)\s+(\S+)", out)
    dg_bar, e_bar = float(leg.group(1)), float(leg.group(2))
    rows, idx = [], []
    for i, path in enumerate(xvgs):
        data, legends = read_xvg(path)
        ndvdl = sum(1 for lg in legends if lg.startswith("dH/d"))
        keep = data[int(0.1 * len(data)):, 1 + ndvdl:][:, [w1, w2]]
        rows.append(keep)
        idx.append(np.full(len(keep), i))
    f, e = mbar(np.concatenate(rows), np.concatenate(idx),
                BOLTZ * runner.params.ref_t)
    dg_mbar, e_mbar = float(f[1] - f[0]), float(e[1])
    _say(f"ethanol (g) the {w1} -> {w2} leg: BAR {dg_bar:.3f} +- "
         f"{e_bar:.3f}, MBAR {dg_mbar:.3f} +- {e_mbar:.3f} kJ/mol "
         f"({len(rows[0])} + {len(rows[1])} samples)")
    if not (np.isfinite([dg_bar, dg_mbar]).all()
            and abs(dg_bar - dg_mbar) <= e_bar + e_mbar + 1e-6):
        raise AssertionError(f"(g) BAR {dg_bar} +- {e_bar}, MBAR "
                             f"{dg_mbar} +- {e_mbar}")

    # (f) the restart under sd: 20 + 20 steps against 40
    _cli_restart(device, counted, f"win{w1}.tpz", "eq.cpt", eq_steps,
                 ETH_RESTART_STEPS, "ethanol (f)")


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
    phase_gather_calls()

    phase_small_reference(device)
    done("small reference")

    system, state = solvation_system(n_side=N_SIDE, seed=0, device=device)
    state = _decoupled(state)
    _say(f"system: {system.n_atoms} atoms, box {float(state.box[0, 0]):.2f}"
         f" nm, PME grid {_params(True).pme_grid}")
    eq_params = _params(mts=False).replace(dt=EQ_DT, tau_t=0.1,
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
    phase_spread_edges(timer)
    phase_gather_edges(timer)
    pme_sync_report(prod, state)
    phase_v2u_edges(prod, state, (eq.config.super_nnbr,
                                  eq.config.fep_max_nbr))
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
    done("K7 layouts")
    # the VF+virial launches come from the K7 C-rescale steps
    layout_counts.update(phase_k7_edges(system, params, state, caps))
    for r in cluster_rows:
        r["launches"] = layout_counts.get(r["name"], 0)
    done("K7 edge cases")
    dd_rows = phase_dd(system, params, state, caps, timer, smi, ms_step)
    done("main path under DD")
    phase_small_charmm(device)
    table_rows, charmm_state, charmm_nnbr = phase_charmm(device, timer, smi,
                                                         state)
    done("CHARMM path")
    phase_table_edges(device, charmm_state, charmm_nnbr)
    done("table kernel edge cases")
    dd_rows += phase_dd_charmm(device, charmm_state, charmm_nnbr, timer,
                               smi)
    done("CHARMM path under DD")
    big_rows = [phase_dd_big(device, smi, timer)]
    done("81,002 atoms")

    window_rows, window_counts, npt_start = phase_window(device, timer, smi)
    done("lambda windows")
    npt_rows, npt_counts, pr_counts = phase_npt(timer, smi, *npt_start)
    done("NPT windows")
    em_counts = phase_cli(device, smi, ms_step)
    done("the CLI (phase 16)")
    phase_ethanol(device, smi, ms_step)
    done("a ligand's dihedrals and restraints under sd (phase 17)")
    for r in rows:      # the main path's K1 and PME rows: the EM path's
        r["launches_em"] = em_counts.get(r["name"], 0)
        if r["name"].startswith("nb_v2u"):    # K1 runs on every path
            r["launches_window"] = window_counts[r["name"]]
            r["launches_npt"] = npt_counts[r["name"]]
            r["launches_pr"] = pr_counts[r["name"]]
    rows += (cluster_rows + table_rows + dd_rows + big_rows + window_rows
             + npt_rows)
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
