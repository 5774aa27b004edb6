"""CI gate for the RMPC kernel-path per-lane XLA rescue.

The whole-solve body runs a FIXED budget; on stiff RLS estimates
(|theta| ~ 10, as closed-loop adaptation produces on far-target low-mu
rolling objects) that budget can under-converge and — fed back through the
estimator — diverge the lane, while the adaptive XLA path (regularisation
ladder + 8-alpha backtracking) converges it. The fix routes lanes that the
body's own certified diagnostics still flag after escalation to one XLA
`solve_batch` and merges per lane (`RMPCBatch.solve_batched`,
`kernel_xla_fallback=True`).

A closed-loop reproduction of the full far-target episode is too slow for
CI on the CPU, so this gate reproduces the MECHANISM at the same code path
(the kernel path forced through `ops.route`) and reduced scale: a deliberately
starved kernel budget on stiff-estimate far-reference lanes, asserting
(a) the kernel path without the fallback leaves lanes uncertified —
the honest-failure precondition, (b) with the fallback every lane is
certified and flagged lanes return the adaptive XLA answer.

Reference behaviour being matched: IPOPT with max_iter=200 on the same OCP
(`RMPC/dev_dual/controller/np_mpc_adaptive_with_linear_regressor.py:158-162`)
— the reference solver never ships an under-converged control silently.
"""

import numpy as np
import jax.numpy as jnp

from dart_tpu.adapt.rls import RLSState
from dart_tpu.control import mpc as mpc_mod
from dart_tpu.ops import route as route_mod

B, N, DT = 128, 6, 0.01
TOL_GRAD = 5e-3


def _make_controller(fallback: bool) -> mpc_mod.RMPCBatch:
    # Starved budget (1 iter x 2 alphas x 1 AL round, no escalation):
    # guarantees under-convergence on the stiff lanes so the gate exercises
    # the flag -> rescue path deterministically.
    return mpc_mod.RMPCBatch(
        N=N, dt=DT,
        cfg=mpc_mod.ilqr.ILQRConfig(max_iters=10, al_iters=3),
        kernel_iters=1, kernel_alphas=2, kernel_al_rounds=1,
        kernel_tol_grad=TOL_GRAD, kernel_max_extra_rounds=0,
        kernel_xla_fallback=fallback)


def _make_batch():
    rng = np.random.default_rng(7)
    states = np.asarray(rng.normal(size=(B, 4)) * 0.02, np.float32)
    # Far 11.2 cm target on the stiff half (the documented failing
    # distance). The benign half sits AT its target with zero velocity —
    # du = 0 is optimal there, so even the starved 1-iteration kernel
    # budget certifies it (the settled steady-state case that dominates
    # production steps and must stay on the kernel fast path).
    targets = np.tile([0.112, 0.0, 0.06, 0.0], (B, 1)).astype(np.float32)
    half = B // 2
    states[:half, 1] = 0.0
    states[:half, 3] = 0.0
    targets[:half] = states[:half]
    states = jnp.asarray(states)
    targets = jnp.asarray(targets)
    # First half: benign early-episode estimates. Second half: STIFF but
    # physically-shaped mid-episode estimates (damping-dominated, strong
    # Coulomb, as RLS produces on rolling objects) — feature layout
    # phi = [p, vx, p, vy, tanh(vx/eps), tanh(vy/eps), 1] per axis
    # (`np_mpc_adaptive_with_linear_regressor.py:171-186`). NOTE random
    # large thetas are the WRONG stiffness model: positive velocity
    # feedback makes the OCP genuinely infeasible (dynamics outrun the
    # +-u_bound control authority) and no solver certifies it.
    th = rng.normal(size=(B, 14)) * 0.3
    half = B // 2
    th[half:] = rng.normal(size=(half, 14)) * 0.2
    th[half:, 1] = -rng.uniform(10, 40, half)       # x viscous damping
    th[half:, 4] = -rng.uniform(2, 8, half)         # x Coulomb (tanh)
    th[half:, 6] = rng.uniform(-1, 1, half)         # x bias
    th[half:, 10] = -rng.uniform(10, 40, half)      # y viscous damping
    th[half:, 12] = -rng.uniform(2, 8, half)        # y Coulomb
    th[half:, 13] = rng.uniform(-1, 1, half)        # y bias
    return states, targets, jnp.asarray(th, jnp.float32)


def _carry_with_theta(ctlr, states, theta14):
    carry = ctlr.init_carry_batch(states)
    rls_x = RLSState(theta=theta14[:, :7], P=carry.rls_x.P)
    rls_y = RLSState(theta=theta14[:, 7:], P=carry.rls_y.P)
    return carry._replace(rls_x=rls_x, rls_y=rls_y)


def test_kernel_rescue_certifies_stiff_lanes():
    states, targets, theta14 = _make_batch()

    # (a) no fallback: the starved kernel budget must leave stiff lanes
    # uncertified — and say so in its diagnostics (the anti-silent-failure
    # property the r2 self-diagnostics added).
    ctlr0 = _make_controller(fallback=False)
    carry0 = _carry_with_theta(ctlr0, states, theta14)
    with route_mod.forced("xla"):
        _, u0, diag0 = ctlr0.solve_batched(carry0, states, targets)
    bad0 = (~(np.asarray(diag0.viol) <= ctlr0.cfg.tol_con)
            | ~(np.asarray(diag0.grad_norm) <= TOL_GRAD))
    assert bad0.any(), (
        "starved kernel budget unexpectedly certified every stiff lane — "
        "the gate lost its failing precondition; tighten the scenario")

    # (b) fallback on: every lane certified, flagged lanes carry the XLA
    # answer (finite, feasible, stationary), untouched lanes unchanged.
    ctlr1 = _make_controller(fallback=True)
    carry1 = _carry_with_theta(ctlr1, states, theta14)
    with route_mod.forced("xla"):
        _, u1, diag1 = ctlr1.solve_batched(carry1, states, targets)
    viol1 = np.asarray(diag1.viol)
    gn1 = np.asarray(diag1.grad_norm)
    assert np.all(np.isfinite(np.asarray(u1)))
    assert np.all(viol1 <= ctlr1.cfg.tol_con + 1e-6), viol1.max()
    # The XLA rescue runs an adaptive 10-iter x 3-AL budget: rescued lanes
    # must be stationary to the same tolerance the kernel path certifies.
    assert np.all(gn1 <= TOL_GRAD), gn1.max()
    # Lanes the kernel already certified are passed through bit-identically.
    good = ~bad0
    assert good.any()
    np.testing.assert_array_equal(np.asarray(u1)[good], np.asarray(u0)[good])

    # Cross-check flagged lanes against the pure XLA path (use_kernel=False)
    # from the same carry: both are converged solutions of the same OCP, so
    # first controls agree to solver tolerance.
    ctlr2 = _make_controller(fallback=False)
    carry2 = _carry_with_theta(ctlr2, states, theta14)
    with route_mod.forced("xla"):
        _, u2, diag2 = ctlr2.solve_batched(carry2, states, targets,
                                           use_kernel=False)
    d = np.abs(np.asarray(u1) - np.asarray(u2))[bad0]
    assert np.percentile(d, 95) < 5e-3, np.percentile(d, 95)
