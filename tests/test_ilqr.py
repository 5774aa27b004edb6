"""Solver validation: box-DDP/AL-iLQR vs analytic LQR and scipy SLSQP.

The reference validates its OCPs only through IPOPT; here SLSQP (single
shooting with exact JAX gradients) is the independent golden oracle on the
same problems (SURVEY.md section 4 test strategy, item b).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.optimize import minimize

from dart_tpu.models import dynamics as dyn
from dart_tpu.solver import ilqr, ocp as ocp_mod
from dart_tpu.control.reference import build_ref_traj


def _slsqp_first_control(ocp, params, aux, z0, N, nu=2, cons_fn=None, tol=1e-12):
    """Golden solve: single-shooting NLP over U with exact gradients."""

    def rollout_cost(Uflat):
        U = Uflat.reshape(N, nu)

        def f(z, inp):
            k, u = inp
            c = ocp.stage_cost(z, u, k, aux)
            return ocp.step(z, u, params), c

        zT, cs = jax.lax.scan(f, z0, (jnp.arange(N), U))
        return jnp.sum(cs) + ocp.term_cost(zT, aux)

    val_grad = jax.jit(jax.value_and_grad(rollout_cost))

    def fun(U):
        v, g = val_grad(jnp.asarray(U))
        return float(v), np.asarray(g)

    bounds = [(ocp.u_lo[i % nu], ocp.u_hi[i % nu]) for i in range(N * nu)]
    constraints = []
    if cons_fn is not None:
        def c_all(Uflat):
            U = Uflat.reshape(N, nu)

            def f(z, inp):
                k, u = inp
                c = ocp.constraints(z, u, k, aux)
                return ocp.step(z, u, params), c

            _, cs = jax.lax.scan(f, z0, (jnp.arange(N), U))
            return -cs.reshape(-1)  # scipy wants c >= 0

        jac = jax.jit(jax.jacrev(c_all))
        constraints = [{
            "type": "ineq",
            "fun": lambda U: np.asarray(c_all(jnp.asarray(U))),
            "jac": lambda U: np.asarray(jac(jnp.asarray(U))),
        }]

    res = minimize(fun, np.zeros(N * nu), jac=True, method="SLSQP",
                   bounds=bounds, constraints=constraints,
                   options={"maxiter": 400, "ftol": tol})
    return res.x.reshape(N, nu), res.fun


def test_ilqr_matches_lqr_analytic():
    """Unconstrained LQR: iLQR must match the closed-form Riccati solution."""
    N, nz, nu = 12, 3, 2
    rng = np.random.default_rng(1)
    A = jnp.asarray(np.eye(nz) + 0.05 * rng.normal(size=(nz, nz)))
    B = jnp.asarray(0.1 * rng.normal(size=(nz, nu)))
    Q = jnp.eye(nz) * 2.0
    R = jnp.eye(nu) * 0.5

    o = ilqr.OCPDef(
        step=lambda z, v, p: A @ z + B @ v,
        stage_cost=lambda z, v, k, aux: z @ Q @ z + v @ R @ v,
        term_cost=lambda z, aux: z @ Q @ z,
        u_lo=(-1e6,) * nu, u_hi=(1e6,) * nu,
    )
    z0 = jnp.asarray(rng.normal(size=nz))
    sol = ilqr.solve(o, ilqr.ILQRConfig(max_iters=30), None, None, z0,
                     jnp.zeros((N, nu)))

    # Discrete Riccati recursion (cost convention: z'Qz + v'Rv, no 1/2)
    P = np.asarray(Q)
    Ks = []
    for _ in range(N):
        An, Bn = np.asarray(A), np.asarray(B)
        K = np.linalg.solve(np.asarray(R) + Bn.T @ P @ Bn, Bn.T @ P @ An)
        P = np.asarray(Q) + An.T @ P @ (An - Bn @ K)
        Ks.append(K)
    Ks = Ks[::-1]
    z = np.asarray(z0)
    V_star = []
    for k in range(N):
        v = -Ks[k] @ z
        V_star.append(v)
        z = np.asarray(A) @ z + np.asarray(B) @ v
    V_star = np.stack(V_star)
    assert np.allclose(np.asarray(sol.V), V_star, atol=1e-6)


def test_pmpc_matches_slsqp():
    N = 10
    o = ocp_mod.make_pmpc_ocp(dt=0.02, u_bound=0.6)
    params = dyn.PMPCParams(mu=0.1, dt=0.02)
    aux = ocp_mod.PMPCAux(
        target=jnp.asarray([0.08, 0.0, -0.05, 0.0, 0.0, 0.0]),
        Qp=jnp.asarray(600.0), Qv=jnp.asarray(5.0), R=jnp.asarray(0.1))
    z0 = jnp.zeros(6)
    sol = ilqr.solve(o, ilqr.ILQRConfig(), params, aux, z0, jnp.zeros((N, 2)))
    U_star, f_star = _slsqp_first_control(o, params, aux, z0, N)
    # First-control agreement is the receding-horizon contract.
    assert np.allclose(np.asarray(sol.V[0]), U_star[0], atol=2e-4), \
        (sol.V[0], U_star[0])
    assert float(sol.cost) <= f_star + 1e-6 * (1 + abs(f_star))


def test_pmpc_bound_saturation():
    """A far target must drive the tilt into its box bound, not beyond."""
    N = 10
    o = ocp_mod.make_pmpc_ocp(dt=0.02, u_bound=0.25)
    params = dyn.PMPCParams(mu=0.1, dt=0.02)
    aux = ocp_mod.PMPCAux(
        target=jnp.asarray([2.0, 0.0, -2.0, 0.0, 0.0, 0.0]),
        Qp=jnp.asarray(600.0), Qv=jnp.asarray(0.0), R=jnp.asarray(0.01))
    sol = ilqr.solve(o, ilqr.ILQRConfig(), params, aux, jnp.zeros(6),
                     jnp.zeros((N, 2)))
    V = np.asarray(sol.V)
    assert np.all(V >= -0.25 - 1e-9) and np.all(V <= 0.25 + 1e-9)
    # Gravity is negative: positive x-target needs negative theta_x tilt.
    assert V[0, 0] == pytest.approx(-0.25, abs=1e-6)
    assert V[0, 1] == pytest.approx(0.25, abs=1e-6)


def test_rmpc_constraints_and_slsqp():
    N = 8
    o = ocp_mod.make_rmpc_ocp(dt=0.02, u_bound=0.4, du_bound=0.05, vmax=0.25)
    params = dyn.RMPCParams(theta=jnp.zeros(14))
    r_v = jnp.asarray([0.0, 0.0, 0.0, 0.0])
    target = jnp.asarray([0.1, 0.0, -0.08, 0.0])
    ref = build_ref_traj(r_v, target, N)
    aux = ocp_mod.RMPCAux(ref=ref, Qp=jnp.asarray(100.0), Qv=jnp.asarray(1.0),
                          Ru=jnp.asarray(0.05), Rdu=jnp.asarray(1.0))
    u_prev = jnp.asarray([0.02, -0.01])
    z0 = jnp.concatenate([jnp.zeros(4), u_prev])
    cfg = ilqr.ILQRConfig(al_iters=6)
    sol = ilqr.solve(o, cfg, params, aux, z0, jnp.zeros((N, 2)))

    V = np.asarray(sol.V)
    # Slew constraint holds including the k=0 u_prev coupling.
    du = np.diff(np.vstack([np.asarray(u_prev), V]), axis=0)
    assert np.all(np.abs(du) <= 0.05 + 1e-5), du
    assert float(sol.viol) < 1e-5

    U_star, f_star = _slsqp_first_control(o, params, aux, z0, N,
                                          cons_fn=o.constraints)
    assert np.allclose(V[0], U_star[0], atol=5e-4), (V[0], U_star[0])


def test_lmpc_solver_improves_and_feasible():
    N = 12
    o = ocp_mod.make_lmpc_ocp(dt=0.02, u_bound=0.4)
    rng = np.random.default_rng(3)
    pvec = jnp.asarray(rng.uniform(0.05, 0.5, size=34))
    target = jnp.asarray([0.05, 0, 0.05, 0, 0, 0, 0, 0.0])
    aux = ocp_mod.LMPCAux(
        target=target,
        Q=jnp.asarray([200.0, 2.0, 200.0, 2.0, 0, 0, 0, 0]),
        R=jnp.asarray([0.1, 0.1, 1.0, 1.0]),
        Qt=jnp.asarray([200.0, 2.0, 200.0, 2.0, 0, 0, 0, 0]))
    z0 = jnp.zeros(10)
    sol = ilqr.solve(o, ilqr.ILQRConfig(), pvec, aux, z0, jnp.zeros((N, 2)))
    # Must strictly beat the zero-control rollout and respect bounds.
    Z0 = np.asarray(sol.Z)
    assert np.all(np.abs(np.asarray(sol.V)) <= 0.4 + 1e-9)
    zero_cost = float(ilqr._raw_cost(o, aux, ilqr._rollout(o, pvec, z0, jnp.zeros((N, 2))), jnp.zeros((N, 2))))
    assert float(sol.cost) < zero_cost
    assert np.all(np.isfinite(Z0))


def test_lmpc_matches_slsqp():
    N = 10
    o = ocp_mod.make_lmpc_ocp(dt=0.02, u_bound=0.4)
    rng = np.random.default_rng(4)
    pvec = jnp.asarray(rng.uniform(0.05, 0.4, size=34))
    aux = ocp_mod.LMPCAux(
        target=jnp.asarray([0.06, 0, -0.04, 0, 0, 0, 0, 0.0]),
        Q=jnp.asarray([200.0, 2.0, 200.0, 2.0, 0, 0, 0, 0]),
        R=jnp.asarray([0.1, 0.1, 1.0, 1.0]),
        Qt=jnp.asarray([200.0, 2.0, 200.0, 2.0, 0, 0, 0, 0]))
    z0 = jnp.zeros(10)
    sol = ilqr.solve(o, ilqr.ILQRConfig(), pvec, aux, z0, jnp.zeros((N, 2)))
    U_star, f_star = _slsqp_first_control(o, pvec, aux, z0, N)
    assert np.allclose(np.asarray(sol.V[0]), U_star[0], atol=1e-3), \
        (sol.V[0], U_star[0])


def test_solver_vmap_batch():
    """Batched solves (the batch-major execution model) equal per-sample
    solves."""
    N, B = 8, 5
    o = ocp_mod.make_pmpc_ocp(dt=0.02, u_bound=0.6)
    rng = np.random.default_rng(5)
    targets = jnp.asarray(rng.uniform(-0.1, 0.1, size=(B, 6)) *
                          np.array([1, 0, 1, 0, 0, 0]))
    mus = jnp.asarray(rng.uniform(0.05, 0.2, size=B))
    z0s = jnp.asarray(rng.normal(size=(B, 6)) * 0.02)
    cfg = ilqr.ILQRConfig()

    def one(mu, t, z0):
        params = dyn.PMPCParams(mu=mu, dt=0.02)
        aux = ocp_mod.PMPCAux(target=t, Qp=jnp.asarray(300.0),
                              Qv=jnp.asarray(2.0), R=jnp.asarray(0.2))
        return ilqr.solve(o, cfg, params, aux, z0, jnp.zeros((N, 2))).V

    batched = np.asarray(jax.vmap(one)(mus, targets, z0s))
    for i in range(B):
        single = np.asarray(one(mus[i], targets[i], z0s[i]))
        assert np.allclose(batched[i], single, atol=1e-8)


def test_projected_grad_norm_and_constraint_max():
    """Diagnostics for the whole-solve kernel paths: pg ~ 0 at a converged
    solution, large at a junk warm start; constraint_max signs correct."""
    import numpy as np

    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.models import dynamics as dyn

    B = 8
    rng = np.random.default_rng(0)
    dtype = jnp.float64
    states = jnp.asarray(rng.normal(size=(B, 6)) * 0.05, dtype)
    z = jnp.zeros((B,), dtype)
    targets = jnp.stack([jnp.asarray(rng.uniform(-0.1, 0.1, B), dtype), z,
                         jnp.asarray(rng.uniform(-0.1, 0.1, B), dtype), z,
                         jnp.full((B,), 0.43, dtype), z], axis=-1)
    ocp = mpc_mod.make_pmpc_ocp(dt=0.01, u_bound=0.6)
    cfg = ilqr.ILQRConfig(max_iters=30)
    params = dyn.PMPCParams(mu=jnp.full((B,), 0.1, dtype), dt=0.01)
    aux = mpc_mod.PMPCAux(target=targets, Qp=jnp.full((B,), 300.0, dtype),
                          Qv=jnp.full((B,), 2.0, dtype),
                          R=jnp.full((B,), 0.2, dtype))
    sol = ilqr.solve_batch(ocp, cfg, params, aux, states,
                           jnp.zeros((B, 15, 2), dtype))
    pg_conv = ilqr.projected_grad_norm(ocp, params, aux, states, sol.V)
    assert float(jnp.max(pg_conv)) < 1e-4, float(jnp.max(pg_conv))
    # a zeroed (unsolved) trajectory is far from stationary
    pg_junk = ilqr.projected_grad_norm(ocp, params, aux, states,
                                       jnp.zeros((B, 15, 2), dtype))
    assert float(jnp.min(pg_junk)) > 10 * float(jnp.max(pg_conv))

    # constraint_max on the slew-exact RMPC OCP: a still trajectory is
    # strictly feasible (negative margin == -vmax at v=0)
    ocp_r = mpc_mod.make_rmpc_ocp_du(dt=0.01, u_bound=0.4, du_bound=0.05,
                                     vmax=0.25)
    theta = jnp.zeros((B, 14), dtype)
    params_r = dyn.RMPCParams(theta=theta, v_eps=jnp.full((B,), 0.1, dtype))
    ref = jnp.zeros((B, 21, 4), dtype)
    aux_r = mpc_mod.RMPCAux(ref=ref, Qp=jnp.full((B,), 100.0, dtype),
                            Qv=jnp.full((B,), 1.0, dtype),
                            Ru=jnp.full((B,), 0.05, dtype),
                            Rdu=jnp.full((B,), 1.0, dtype))
    z0 = jnp.zeros((B, 6), dtype)
    cmax = ilqr.constraint_max(ocp_r, params_r, aux_r, z0,
                               jnp.zeros((B, 20, 2), dtype))
    assert float(jnp.max(cmax)) < 0.0
