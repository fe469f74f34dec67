"""GROMACS-compatible unit system (reference: src/gromacs/math/units.h).

Copy of gromacs_fep_gpu_tpu/core/units.py (the port imports nothing of the
JAX package).

Base units: length nm, time ps, mass amu (g/mol), energy kJ/mol, charge e,
temperature K.  Derived: velocity nm/ps, force kJ/mol/nm, pressure bar.
"""

# Coulomb conversion factor: 1/(4 pi eps0) in kJ mol^-1 nm e^-2
# (reference units.h: ONE_4PI_EPS0 = 138.935458...)
ONE_4PI_EPS0 = 138.935458

# Boltzmann constant, kJ mol^-1 K^-1 (reference units.h BOLTZ)
BOLTZ = 0.008314462618153242

# Pressure conversion: (kJ mol^-1 nm^-3) -> bar (reference units.h PRESFAC)
PRESFAC = 16.6054

# Avogadro / misc
AVOGADRO = 6.02214076e23

# Degrees <-> radians
import math

DEG2RAD = math.pi / 180.0
RAD2DEG = 180.0 / math.pi
