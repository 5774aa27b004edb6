"""Fixed-budget RMPC whole-solve body (AL outer loop included): parity with
the generic constrained batch solver on the slew-exact OCP at a matched
budget."""

import numpy as np
import jax.numpy as jnp

from dart_tpu.control.reference import build_ref_traj
from dart_tpu.ops.rmpc_solve import rmpc_solve
from dart_tpu.solver import ilqr
from dart_tpu.solver.ocp import RMPCAux, make_rmpc_ocp_du
from dart_tpu.models import dynamics as dyn
import jax

DT = 0.02
U_B, DU_B, VMAX, V_EPS = 0.4, 0.05, 0.25, 0.1


def test_whole_solve_kernel_matches_generic_al_solver():
    B, N = 128, 6   # small horizon keeps the CPU compile short
    rng = np.random.default_rng(2)
    # Physical-ish regressor estimates: damping-dominated with small
    # couplings, as RLS produces mid-episode.
    thetas = jnp.asarray(rng.normal(size=(B, 14)) * 0.3, jnp.float32)
    states = jnp.asarray(rng.normal(size=(B, 4)) * 0.05, jnp.float32)
    up0 = jnp.asarray(rng.uniform(-0.1, 0.1, (B, 2)), jnp.float32)
    tmask = np.array([1, 0, 1, 0], np.float32)
    targets = jnp.asarray(rng.uniform(-0.08, 0.08, (B, 4)) * tmask,
                          jnp.float32)
    refs = jax.vmap(lambda s, t: build_ref_traj(
        s * jnp.asarray(tmask), t, N, 0.2))(states, targets)   # (B, N+1, 4)
    z0 = jnp.concatenate([states, up0], axis=-1)
    V0 = jnp.zeros((B, N, 2), jnp.float32)

    Qp, Qv, Ru, Rdu = 100.0, 1.0, 0.05, 1.0
    bc = lambda v: jnp.full((B,), v, jnp.float32)
    aux = RMPCAux(ref=refs, Qp=bc(Qp), Qv=bc(Qv), Ru=bc(Ru), Rdu=bc(Rdu))
    params = dyn.RMPCParams(theta=thetas, g=bc(dyn.GRAVITY_Z), v_eps=bc(V_EPS))
    ocp = make_rmpc_ocp_du(dt=DT, u_bound=U_B, du_bound=DU_B, vmax=VMAX)
    cfg = ilqr.ILQRConfig(max_iters=2, n_alphas=3, al_iters=2,
                          reg_init=1e-9, tol_cost=1e-9)
    sol = ilqr.solve_batch(ocp, cfg, params, aux, z0, V0)

    tl = lambda x: jnp.moveaxis(jnp.asarray(x), 0, -1)
    w = jnp.stack([bc(Qp), bc(Qv), bc(Ru), bc(Rdu)])           # (4, B)
    V_p, cost_p, viol_p, gnorm_p = rmpc_solve(
        tl(thetas), tl(refs), w, tl(z0), tl(V0), dt=DT, u_bound=U_B,
        du_bound=DU_B, vmax=VMAX, v_eps=V_EPS, n_iters=2, n_alphas=3,
        al_rounds=2)
    V_p = jnp.moveaxis(V_p, -1, 0)

    assert np.allclose(np.asarray(cost_p), np.asarray(sol.cost),
                       rtol=5e-3, atol=1e-4), \
        np.max(np.abs(np.asarray(cost_p) - np.asarray(sol.cost)))
    d = np.abs(np.asarray(V_p[:, 0] - sol.V[:, 0]))
    assert np.percentile(d, 99) < 2e-3, np.percentile(d, 99)
    assert np.all(np.abs(np.asarray(V_p)) <= DU_B + 1e-6)
    # Constraint violations agree (both should be tiny on these scenarios).
    assert np.allclose(np.asarray(viol_p), np.asarray(sol.viol), atol=1e-4)
