"""Closed-form linearisation (structure-exploiting solver paths) vs autodiff.

The OCP builders can attach hand-derived dynamics Jacobians and cost
quadratics (`OCPDef.dyn_jac` / `cost_quad` / `term_quad`, via `fast=True`)
that replace the generic jacfwd/hessian stage of `ilqr._linearize`. These
tests pin every closed form to the autodiff ground truth at random points
and end-to-end on full solves (fast OCP vs `fast=False` OCP).

NOTE: `fast=False` is the default on purpose. Measured on the CPU
(tools/bench_fastpaths.py), XLA compiles the vmapped-jacfwd linearisation
into better code than the hand-assembled sparse closed forms (faster
runs and compiles): vectorized tangent propagation fuses into the RK4
dataflow, while explicit per-stage (nz,nz) matrix assembly and tiny matmul
chains do not. Structure only wins when it eliminates linearisation
entirely (PMPC's affine exact discretisation, `solver/pmpc_fast.py`) or
fuses the whole solve into one kernel (`ops/pallas/pmpc_solve.py`).
"""

import numpy as np
import jax
import jax.numpy as jnp

from dart_tpu.models import dynamics as dyn
from dart_tpu.solver import ilqr, ocp as ocp_mod


def _assert_jac_matches(f, f_jac, x, u, p, atol=1e-11):
    A, B = f_jac(x, u, p)
    A_ref = jax.jacfwd(f, argnums=0)(x, u, p)
    B_ref = jax.jacfwd(f, argnums=1)(x, u, p)
    np.testing.assert_allclose(np.asarray(A), np.asarray(A_ref), atol=atol)
    np.testing.assert_allclose(np.asarray(B), np.asarray(B_ref), atol=atol)


def test_pmpc_continuous_jacobian():
    p = dyn.PMPCParams(mu=0.13, g=-9.81, dt=0.002)
    rng = np.random.default_rng(0)
    for _ in range(4):
        x = jnp.asarray(rng.normal(0, 0.2, 6))
        u = jnp.asarray(rng.uniform(-0.5, 0.5, 2))
        _assert_jac_matches(dyn.pmpc_dynamics, dyn.pmpc_jac, x, u, p)


def test_rmpc_continuous_jacobian():
    rng = np.random.default_rng(1)
    p = dyn.RMPCParams(theta=jnp.asarray(rng.normal(0, 0.5, 14)))
    for _ in range(4):
        x = jnp.asarray(rng.normal(0, 0.3, 4))
        u = jnp.asarray(rng.uniform(-0.4, 0.4, 2))
        _assert_jac_matches(dyn.rmpc_dynamics, dyn.rmpc_jac, x, u, p)
    # zero-velocity point: pins the tanh-feature slope at the origin
    _assert_jac_matches(dyn.rmpc_dynamics, dyn.rmpc_jac,
                        jnp.asarray([0.05, 0.0, -0.02, 0.0]),
                        jnp.asarray([0.1, -0.1]), p)


def test_lmpc_continuous_jacobian():
    rng = np.random.default_rng(2)
    pvec = jnp.asarray(rng.uniform(0.05, 0.5, 34))
    for _ in range(6):
        x = jnp.asarray(rng.normal(0, 0.3, 8))
        u = jnp.asarray(rng.uniform(-0.4, 0.4, 2))
        _assert_jac_matches(dyn.lmpc_dynamics, dyn.lmpc_jac, x, u, pvec,
                            atol=1e-9)
    # rest point: pins the sign(0)=0 convention of the |v| derivative
    _assert_jac_matches(dyn.lmpc_dynamics, dyn.lmpc_jac, jnp.zeros(8),
                        jnp.zeros(2), pvec, atol=1e-9)


def test_rk4_chain_rule_matches_discrete_jacfwd():
    rng = np.random.default_rng(3)
    pvec = jnp.asarray(rng.uniform(0.05, 0.5, 34))
    step = dyn.discretize(dyn.lmpc_dynamics, 0.02)
    x = jnp.asarray(rng.normal(0, 0.2, 8))
    u = jnp.asarray(rng.uniform(-0.3, 0.3, 2))
    Ad, Bd = dyn.rk4_jac(dyn.lmpc_dynamics, dyn.lmpc_jac, x, u, pvec, 0.02)
    A_ref = jax.jacfwd(step, argnums=0)(x, u, pvec)
    B_ref = jax.jacfwd(step, argnums=1)(x, u, pvec)
    np.testing.assert_allclose(np.asarray(Ad), np.asarray(A_ref), atol=1e-11)
    np.testing.assert_allclose(np.asarray(Bd), np.asarray(B_ref), atol=1e-11)


def _linearize_pair(o_fast, o_slow, params, aux, Z, V, lam, mu):
    out_f = ilqr._linearize(o_fast, params, aux, Z, V, lam, mu)
    out_s = ilqr._linearize(o_slow, params, aux, Z, V, lam, mu)
    names = ["A", "B", "lx", "lu", "lxx", "lux", "luu", "gx", "gxx"]
    for name, a, b in zip(names, out_f, out_s):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9,
                                   err_msg=name)


def test_pmpc_ocp_linearize_parity():
    N = 8
    o_f = ocp_mod.make_pmpc_ocp(dt=0.02, fast=True)
    o_s = ocp_mod.make_pmpc_ocp(dt=0.02, fast=False)
    params = dyn.PMPCParams(mu=0.1, g=-9.81, dt=0.02)
    aux = ocp_mod.PMPCAux(target=jnp.asarray([0.05, 0, -0.03, 0, 0, 0.0]),
                          Qp=jnp.asarray(300.0), Qv=jnp.asarray(10.0),
                          R=jnp.asarray(2.0))
    rng = np.random.default_rng(4)
    Z = jnp.asarray(rng.normal(0, 0.1, (N + 1, 6)))
    V = jnp.asarray(rng.uniform(-0.4, 0.4, (N, 2)))
    lam = jnp.zeros((N, 1))
    _linearize_pair(o_f, o_s, params, aux, Z, V, lam, jnp.asarray(10.0))


def test_rmpc_ocp_linearize_parity_with_active_constraints():
    N = 8
    kw = dict(dt=0.02, u_bound=0.4, du_bound=0.05, vmax=0.25)
    o_f = ocp_mod.make_rmpc_ocp(fast=True, **kw)
    o_s = ocp_mod.make_rmpc_ocp(fast=False, **kw)
    rng = np.random.default_rng(5)
    params = dyn.RMPCParams(theta=jnp.asarray(rng.normal(0, 0.5, 14)))
    ref = jnp.tile(jnp.asarray([0.05, 0, -0.03, 0.0]), (N + 1, 1))
    aux = ocp_mod.RMPCAux(ref=ref, Qp=jnp.asarray(100.0),
                          Qv=jnp.asarray(1.0), Ru=jnp.asarray(0.5),
                          Rdu=jnp.asarray(5.0))
    # velocities straddling vmax and du straddling du_bound -> both active
    # and inactive PHR rows are exercised; positive multipliers too.
    Z = jnp.asarray(rng.normal(0, 0.3, (N + 1, 6)))
    V = jnp.asarray(rng.uniform(-0.4, 0.4, (N, 2)))
    lam = jnp.asarray(rng.uniform(0, 2.0, (N, 8)))
    _linearize_pair(o_f, o_s, params, aux, Z, V, lam, jnp.asarray(10.0))


def test_rmpc_du_ocp_linearize_parity():
    N = 8
    kw = dict(dt=0.02, u_bound=0.4, du_bound=0.05, vmax=0.25)
    o_f = ocp_mod.make_rmpc_ocp_du(fast=True, **kw)
    o_s = ocp_mod.make_rmpc_ocp_du(fast=False, **kw)
    rng = np.random.default_rng(6)
    params = dyn.RMPCParams(theta=jnp.asarray(rng.normal(0, 0.5, 14)))
    ref = jnp.tile(jnp.asarray([0.05, 0, -0.03, 0.0]), (N + 1, 1))
    aux = ocp_mod.RMPCAux(ref=ref, Qp=jnp.asarray(100.0),
                          Qv=jnp.asarray(1.0), Ru=jnp.asarray(0.5),
                          Rdu=jnp.asarray(5.0))
    # u_prev + v inside the tilt bound (the clip mask is exercised on the
    # saturated branch separately below)
    Z = jnp.asarray(rng.normal(0, 0.2, (N + 1, 6)))
    Z = Z.at[:, 4:6].set(jnp.asarray(rng.uniform(-0.2, 0.2, (N + 1, 2))))
    V = jnp.asarray(rng.uniform(-0.05, 0.05, (N, 2)))
    lam = jnp.asarray(rng.uniform(0, 2.0, (N, 4)))
    _linearize_pair(o_f, o_s, params, aux, Z, V, lam, jnp.asarray(10.0))
    # saturated tilt: |u_prev + v| > u_bound -> clip mask = 0 branch
    Zs = Z.at[:, 4:6].set(0.39)
    Vs = jnp.full((N, 2), 0.05)
    _linearize_pair(o_f, o_s, params, aux, Zs, Vs, lam, jnp.asarray(10.0))


def test_lmpc_ocp_linearize_parity():
    N = 8
    o_f = ocp_mod.make_lmpc_ocp(dt=0.02, fast=True)
    o_s = ocp_mod.make_lmpc_ocp(dt=0.02, fast=False)
    rng = np.random.default_rng(7)
    pvec = jnp.asarray(rng.uniform(0.05, 0.5, 34))
    aux = ocp_mod.LMPCAux(
        target=jnp.asarray([0.05, 0, 0.05, 0, 0, 0, 0, 0.0]),
        Q=jnp.asarray([200.0, 2.0, 200.0, 2.0, 0, 0, 0, 0]),
        R=jnp.asarray([0.1, 0.1, 1.0, 1.0]),
        Qt=jnp.asarray([200.0, 2.0, 200.0, 2.0, 0, 0, 0, 0]))
    Z = jnp.asarray(rng.normal(0, 0.2, (N + 1, 10)))
    V = jnp.asarray(rng.uniform(-0.4, 0.4, (N, 2)))
    lam = jnp.zeros((N, 1))
    _linearize_pair(o_f, o_s, pvec, aux, Z, V, lam, jnp.asarray(10.0))


def test_lmpc_solve_parity_fast_vs_generic():
    N = 10
    rng = np.random.default_rng(8)
    pvec = jnp.asarray(rng.uniform(0.05, 0.4, 34))
    aux = ocp_mod.LMPCAux(
        target=jnp.asarray([0.06, 0, -0.04, 0, 0, 0, 0, 0.0]),
        Q=jnp.asarray([200.0, 2.0, 200.0, 2.0, 0, 0, 0, 0]),
        R=jnp.asarray([0.1, 0.1, 1.0, 1.0]),
        Qt=jnp.asarray([200.0, 2.0, 200.0, 2.0, 0, 0, 0, 0]))
    z0 = jnp.zeros(10)
    cfg = ilqr.ILQRConfig()
    s_f = ilqr.solve(ocp_mod.make_lmpc_ocp(dt=0.02, fast=True), cfg, pvec,
                     aux, z0, jnp.zeros((N, 2)))
    s_s = ilqr.solve(ocp_mod.make_lmpc_ocp(dt=0.02, fast=False), cfg, pvec,
                     aux, z0, jnp.zeros((N, 2)))
    np.testing.assert_allclose(np.asarray(s_f.V), np.asarray(s_s.V),
                               atol=1e-7)
    np.testing.assert_allclose(float(s_f.cost), float(s_s.cost), rtol=1e-9)


def test_rmpc_du_solve_parity_fast_vs_generic():
    N = 10
    rng = np.random.default_rng(9)
    params = dyn.RMPCParams(theta=jnp.asarray(rng.normal(0, 0.2, 14)))
    ref = jnp.tile(jnp.asarray([0.05, 0, -0.03, 0.0]), (N + 1, 1))
    aux = ocp_mod.RMPCAux(ref=ref, Qp=jnp.asarray(100.0),
                          Qv=jnp.asarray(1.0), Ru=jnp.asarray(0.5),
                          Rdu=jnp.asarray(5.0))
    z0 = jnp.zeros(6)
    cfg = ilqr.ILQRConfig()
    kw = dict(dt=0.02, u_bound=0.4, du_bound=0.05, vmax=0.25)
    s_f = ilqr.solve(ocp_mod.make_rmpc_ocp_du(fast=True, **kw), cfg, params,
                     aux, z0, jnp.zeros((N, 2)))
    s_s = ilqr.solve(ocp_mod.make_rmpc_ocp_du(fast=False, **kw), cfg, params,
                     aux, z0, jnp.zeros((N, 2)))
    np.testing.assert_allclose(np.asarray(s_f.V), np.asarray(s_s.V),
                               atol=1e-6)
    np.testing.assert_allclose(float(s_f.cost), float(s_s.cost), rtol=1e-8)
