"""Lambda ladders — PyTorch-side counterpart of
gromacs_fep_gpu_tpu/parallel/ensemble.py (lambda_schedule only; the
batched ensemble step, replica exchange and the device mesh are not
ported yet)."""
from __future__ import annotations

import numpy as np

from ..core.types import FepCoupling


def lambda_schedule(n_lambda: int, components=(FepCoupling.COUL,
                                               FepCoupling.VDW,
                                               FepCoupling.BONDED)):
    """(L, 7) linear lambda vectors, float32 numpy (reference: t_lambda
    all_lambda)."""
    lams = np.zeros((n_lambda, int(FepCoupling.COUNT)), np.float32)
    ramp = np.linspace(0.0, 1.0, n_lambda, dtype=np.float32)
    for c in components:
        lams[:, int(c)] = ramp
    return lams
