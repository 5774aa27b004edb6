"""Structure-exploiting PMPC solver: exactness of the affine discretization
and solution parity with the generic box-DDP path."""

import numpy as np
import jax
import jax.numpy as jnp

from dart_tpu.models import dynamics as dyn
from dart_tpu.solver import ilqr, pmpc_fast
from dart_tpu.solver.ocp import PMPCAux, make_pmpc_ocp

DT = 0.002


def _problem(B, N, rng):
    mus = jnp.asarray(rng.uniform(0.05, 0.2, B))
    tgts = jnp.asarray(rng.uniform(-0.1, 0.1, (B, 6)) *
                       np.array([1, 0, 1, 0, 0, 0]))
    z0 = jnp.asarray(rng.normal(size=(B, 6)) * 0.02)
    aux = PMPCAux(target=tgts, Qp=jnp.full(B, 300.0), Qv=jnp.full(B, 2.0),
                  R=jnp.full(B, 0.2))
    return mus, aux, z0


def test_affine_discretization_equals_rk4():
    rng = np.random.default_rng(0)
    B = 8
    mus, _, z0 = _problem(B, 15, rng)
    us = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 2)))
    Ad, Sd = pmpc_fast._affine_discretization(mus, -9.81, DT)
    step = dyn.discretize(dyn.pmpc_dynamics, DT)
    x_rk4 = jax.vmap(lambda x, u, mu: step(
        x, u, dyn.PMPCParams(mu=mu, dt=DT)))(z0, us, mus)
    x_aff = jnp.einsum("bij,bj->bi", Ad, z0) + \
        jnp.einsum("bij,bj->bi", Sd, pmpc_fast._c_of_u(us, -9.81, DT))
    assert np.allclose(np.asarray(x_rk4), np.asarray(x_aff), atol=1e-14)


def test_dcdu_matches_autodiff():
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.uniform(-0.5, 0.5, 2))
    J = jax.jacfwd(lambda uu: pmpc_fast._c_of_u(uu, -9.81, DT))(u)
    J_closed = pmpc_fast._dcdu(u, -9.81, DT)
    assert np.allclose(np.asarray(J), np.asarray(J_closed), atol=1e-12)


def test_fast_solver_matches_generic():
    rng = np.random.default_rng(2)
    B, N = 12, 15
    mus, aux, z0 = _problem(B, N, rng)
    V0 = jnp.zeros((B, N, 2))
    ocp = make_pmpc_ocp(dt=DT, u_bound=0.6)
    params = dyn.PMPCParams(mu=mus, dt=jnp.full(B, DT))
    ref = ilqr.solve_batch(ocp, ilqr.ILQRConfig(max_iters=6), params, aux,
                           z0, V0)
    V_f, Z_f, cost_f = pmpc_fast.solve_batch_fast(
        mus, aux, z0, V0, dt=DT, max_iters=6)
    assert np.allclose(np.asarray(ref.cost), np.asarray(cost_f), rtol=1e-10)
    assert np.allclose(np.asarray(ref.V), np.asarray(V_f), atol=1e-10)
    assert np.allclose(np.asarray(ref.Z), np.asarray(Z_f), atol=1e-10)
