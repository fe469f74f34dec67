"""The leapfrog Langevin (sd) integrator: the port against the JAX
package on the same draws.

langevin_sd takes its N(0, 1) draws as an argument in the port; the
tests draw them with jax.random.normal on JAX's own key and feed both
versions the same numbers.  Tolerances: the update alone rel 1e-6 (float32,
the same formula; JAX's exp(-dt/tau) is a float32, the port's a double);
one whole step (dense forces, SD, SETTLE after the whole update) positions
1e-6 nm and velocities 1e-3 nm/ps (1e-6 nm of position over dt = 1 fs, as
tests/test_torch_md.py's velocity constraint), temperature rel 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gromacs_fep_gpu_tpu.core import types as jtypes
from gromacs_fep_gpu_tpu.md import integrators as jinteg
from gromacs_fep_gpu_tpu.md.simulator import make_step_fn as j_step_fn
from gromacs_fep_gpu_tpu.models.solvation import solvation_system
from gromacs_fep_gpu_tpu.ops.forces import make_dense_force_fn as j_dense
from gromacs_fep_gpu_tpu_torch.core import types as ttypes
from gromacs_fep_gpu_tpu_torch.md import integrators as tinteg
from gromacs_fep_gpu_tpu_torch.md.simulator import make_step_fn as t_step_fn
from gromacs_fep_gpu_tpu_torch.ops.forces import make_dense_force_fn as t_dense

from torch_bridge import md_params, t, to_port


def test_langevin_sd_matches_jax():
    rng = np.random.default_rng(2)
    n = 40
    x = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    v = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    f = rng.normal(0, 300, (n, 3)).astype(np.float32)
    invm = (1.0 / rng.uniform(1, 16, n)).astype(np.float32)
    invm[3] = 0.0                       # a massless site: no noise
    key = jax.random.PRNGKey(7)
    xi = jax.random.normal(key, v.shape, jnp.float32)
    for tau_t in (0.1, 1.0):
        xj, vj = jinteg.langevin_sd(jnp.asarray(x), jnp.asarray(v),
                                    jnp.asarray(f), jnp.asarray(invm), 0.002,
                                    tau_t, 300.0, key)
        xt, vt = tinteg.langevin_sd(t(x), t(v), t(f), t(invm), 0.002, tau_t,
                                    300.0, t(xi))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6,
                                   atol=1e-6)
        # friction alone on the massless site
        np.testing.assert_allclose(vt[3].numpy(),
                                   np.exp(-0.002 / tau_t) * v[3], rtol=1e-6)


def test_sd_draws_come_from_the_generator():
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    a = tinteg.sd_draws((5, 3), g)
    g.manual_seed(3)
    b = tinteg.sd_draws((5, 3), g)
    assert torch.equal(a, b) and a.shape == (5, 3)
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    assert not torch.equal(a, tinteg.sd_draws((5, 3), g))


def _sd_params(mod, **kw):
    return md_params(mod, dt=0.001, integrator="sd", tau_t=0.5, ref_t=300.0,
                     rcoulomb=0.6, rvdw=0.6, rlist=0.6, nstcomm=1,
                     coulomb="reaction-field",
                     fep=dict(enabled=True, sc_alpha=0.5, sc_coul=True),
                     **kw)


def test_sd_step_with_settle_matches_jax(monkeypatch):
    """One whole step of a water box with the 5-site ligand: dense forces,
    the SD update on JAX's k_sd draws, SETTLE after it, COM removal, the
    half-step kinetic energy."""
    js, jst = solvation_system(n_side=3, spacing=0.4, seed=5)
    jst = jst.replace(step=jnp.asarray(3, jnp.int32))
    jp, tp = _sd_params(jtypes), _sd_params(ttypes)
    jforce = j_dense(js, jp)
    jstep = jax.jit(j_step_fn(js, jp, jforce))
    st_j, log_j = jstep(jst)
    key = jax.random.fold_in(jst.rng, 3)
    xi = np.asarray(jax.random.normal(jax.random.split(key, 3)[1],
                                      jst.v.shape, jst.v.dtype))

    ts, tst = to_port(js, jst)
    tst = tst.replace(step=3)
    dense = t_dense(ts, tp)
    monkeypatch.setattr(tinteg, "sd_draws", lambda shape, gen, dtype: t(xi))
    g = torch.Generator(device="cpu")
    tstep = t_step_fn(ts, tp, lambda x, box, lam, fl: dense(x, box, lam), g)
    st_t, log_t = tstep(tst, "E")
    np.testing.assert_allclose(st_t.x.numpy(), np.asarray(st_j.x), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(st_t.v.numpy(), np.asarray(st_j.v), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(float(log_t.temp), float(log_j.temp),
                               rtol=1e-5)
    np.testing.assert_allclose(float(log_t.epot), float(log_j.epot),
                               rtol=1e-5)
    # the SETTLE waters keep their geometry after the stochastic update
    o, h1 = ts.settle.atoms[:, 0], ts.settle.atoms[:, 1]
    d = torch.linalg.norm(st_t.x[o] - st_t.x[h1], dim=-1)
    np.testing.assert_allclose(d.numpy(), ts.settle.d_oh.numpy(), rtol=1e-5)


def test_sd_step_refuses_a_second_thermostat():
    js, jst = solvation_system(n_side=3, spacing=0.4, seed=5)
    ts, _ = to_port(js, jst)
    dense = t_dense(ts, _sd_params(ttypes))
    g = torch.Generator(device="cpu")
    with pytest.raises(ValueError, match="sd is the thermostat"):
        t_step_fn(ts, _sd_params(ttypes, tcoupl="v-rescale"), dense, g)
    with pytest.raises(ValueError, match="Generator"):
        t_step_fn(ts, _sd_params(ttypes), dense, None)
