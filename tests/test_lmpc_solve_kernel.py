"""Fixed-budget LMPC whole-solve body: parity with the generic batch solver
on the same OCP at a matched iteration budget."""

import numpy as np
import jax.numpy as jnp

from dart_tpu.control.mpc import LMPC_DEFAULT_WEIGHTS
from dart_tpu.ops.lmpc_solve import lmpc_solve
from dart_tpu.solver import ilqr
from dart_tpu.solver.ocp import LMPCAux, make_lmpc_ocp

DT = 0.02
U_BOUND = 0.4


def test_whole_solve_kernel_matches_generic_solver():
    B, N = 128, 6   # small horizon keeps the CPU compile short
    rng = np.random.default_rng(1)
    pvecs = jnp.asarray(rng.uniform(0.05, 0.5, (B, 34)), jnp.float32)
    tmask = np.array([1, 0, 1, 0, 0, 0, 0, 0], np.float32)
    tgts = jnp.asarray(rng.uniform(-0.08, 0.08, (B, 8)) * tmask, jnp.float32)
    x0 = jnp.asarray(rng.normal(size=(B, 8)) * 0.02, jnp.float32)
    up0 = jnp.zeros((B, 2), jnp.float32)
    z0 = jnp.concatenate([x0, up0], axis=-1)
    V0 = jnp.zeros((B, N, 2), jnp.float32)

    w = LMPC_DEFAULT_WEIGHTS
    bt = lambda a, n: jnp.broadcast_to(jnp.asarray(a, jnp.float32), (B, n))
    aux = LMPCAux(target=tgts, Q=bt(w.Q, 8), R=bt(w.R, 4), Qt=bt(w.Qt, 8))
    ocp = make_lmpc_ocp(dt=DT, u_bound=U_BOUND)
    cfg = ilqr.ILQRConfig(max_iters=2, n_alphas=3, reg_init=1e-9,
                          tol_cost=1e-9)
    sol = ilqr.solve_batch(ocp, cfg, pvecs, aux, z0, V0)

    tl = lambda x: jnp.moveaxis(jnp.asarray(x), 0, -1)
    V_p, cost_p, gnorm_p = lmpc_solve(
        tl(pvecs), tl(aux.Q), tl(aux.R), tl(aux.Qt), tl(tgts), tl(z0),
        tl(V0), dt=DT, u_bound=U_BOUND, n_iters=2, n_alphas=3)
    V_p = jnp.moveaxis(V_p, -1, 0)

    # Same iteration budget, same problem: costs agree tightly.
    assert np.allclose(np.asarray(cost_p), np.asarray(sol.cost),
                       rtol=5e-3, atol=1e-4), \
        np.max(np.abs(np.asarray(cost_p) - np.asarray(sol.cost)))
    d = np.abs(np.asarray(V_p[:, 0] - sol.V[:, 0]))
    assert np.percentile(d, 99) < 5e-3, np.percentile(d, 99)
    assert np.all(np.abs(np.asarray(V_p)) <= U_BOUND + 1e-6)
