"""The flagship system built by the port equals the JAX package's, field by
field (same numpy RandomState stream, same topology expansion).

Tolerance: exact for every integer, mask and parameter array; float32
coordinates and velocities exact as well (both sides do the same float64
numpy arithmetic and round once)."""
import numpy as np
import pytest

from gromacs_fep_gpu_tpu.models.solvation import solvation_system as j_solv
from gromacs_fep_gpu_tpu_torch.core.types import to_numpy
from gromacs_fep_gpu_tpu_torch.models.solvation import \
    solvation_system as t_solv

from torch_bridge import state_arrays, system_arrays


@pytest.mark.parametrize("n_side,seed", [(6, 0), (5, 3)])
def test_solvation_system_equal_field_by_field(n_side, seed):
    js, jst = j_solv(n_side=n_side, seed=seed)
    ts, tst = t_solv(n_side=n_side, seed=seed, device="cpu")
    want = system_arrays(js)
    got = to_numpy(ts)
    assert sorted(got) == sorted(want)
    assert ts.n_atoms == js.n_atoms
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in state_arrays(jst).items():
        np.testing.assert_array_equal(getattr(tst, k).numpy(), v, err_msg=k)
