"""Batched constrained trajectory optimisation: box-DDP + augmented Lagrangian.

This module is the batched replacement for every CasADi+IPOPT NLP in the
reference (`PMPC/src/controller/mpc_3d.py:81-85`,
`RMPC/dev_dual/controller/np_mpc_adaptive_with_linear_regressor.py:157-162`,
`LMPC/src/controller/rlmpc2.py:479-491`). Where IPOPT solves the sparse
multiple-shooting NLP with an interior-point method on one CPU core, we solve
the same optimal-control problems with:

- a Riccati backward pass (`lax.scan`) whose per-stage subproblem is an
  *exact* box QP over the tilt command (nu = 2 -> active-set enumeration,
  `dart_tpu.ops.boxqp`), giving control-limited DDP (Tassa et al. 2014);
- an augmented-Lagrangian outer loop for the remaining inequality
  constraints (slew-rate, velocity caps) — AL-iLQR;
- jacobians/hessians from `jax.jacfwd`/`jax.hessian` instead of CasADi
  symbolic AD;
- everything jit-compiled with static shapes, so thousands of scenario
  solves batch under `vmap` and shard over a device mesh.

The decision-variable layout differs from IPOPT's (single shooting with
feedback gains vs multiple shooting) but the optimisation problem is the
same; tests validate the returned first control against scipy SLSQP golden
solutions on the reference OCPs.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from dart_tpu.ops.boxqp import boxqp


class OCPDef(NamedTuple):
    """A discrete-time optimal-control problem over horizon N.

    States z may be *augmented* (e.g. [x, u_prev] to express slew costs);
    variant front-ends in `dart_tpu.solver.ocp` build these.
    """

    step: Callable[[jnp.ndarray, jnp.ndarray, Any], jnp.ndarray]
    stage_cost: Callable[[jnp.ndarray, jnp.ndarray, jnp.ndarray, Any], jnp.ndarray]
    term_cost: Callable[[jnp.ndarray, Any], jnp.ndarray]
    # Control bounds as static tuples (OCPDef must stay hashable for jit).
    u_lo: tuple
    u_hi: tuple
    # c(z, v, k, aux) <= 0 elementwise, applied at stages 0..N-1.
    constraints: Optional[Callable[[jnp.ndarray, jnp.ndarray, jnp.ndarray, Any], jnp.ndarray]] = None
    n_con: int = 0
    # Structure-exploiting overrides (closed-form linearisation). When set,
    # `_linearize` uses them instead of jacfwd/hessian autodiff — this removes
    # the dominant per-iteration cost of the generic path (pushing nz+nu
    # tangents through 4 RK4 dynamics evaluations per stage).
    #   dyn_jac(z, v, params) -> (A (nz,nz), B (nz,nu)) of the DISCRETE step
    #   cost_quad(k, z, v, lam_k, mu, aux) -> (lz, lv, lzz, lvz, lvv) of the
    #     AL-penalised stage cost; term_quad(z, aux) -> (gz, gzz).
    dyn_jac: Optional[Callable[[jnp.ndarray, jnp.ndarray, Any], tuple]] = None
    cost_quad: Optional[Callable[..., tuple]] = None
    term_quad: Optional[Callable[[jnp.ndarray, Any], tuple]] = None


class ILQRConfig(NamedTuple):
    max_iters: int = 60          # inner iLQR iterations per AL round
    al_iters: int = 5            # augmented-Lagrangian rounds
    mu_init: float = 10.0        # initial penalty weight
    mu_scale: float = 10.0       # penalty growth when violation stalls
    mu_max: float = 1e8
    tol_con: float = 1e-8        # constraint violation target
    tol_step: float = 1e-7       # max feedforward step for convergence
    tol_cost: float = 1e-9       # relative cost decrease for convergence
    reg_init: float = 1e-6
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_up: float = 8.0
    reg_down: float = 0.25
    n_alphas: int = 11           # line-search resolution (0.6^k)
    # "backtrack": sequential trials, stop at first improvement (fast path —
    # warm-started receding-horizon solves accept alpha=1 almost always).
    # "parallel": evaluate all alphas at once and take the best (more robust
    # from cold starts; used by default in the AL outer loop's first round).
    linesearch: str = "backtrack"


class ILQRSolution(NamedTuple):
    V: jnp.ndarray          # (N, nu) optimal open-loop controls
    Z: jnp.ndarray          # (N+1, nz) corresponding state trajectory
    K: jnp.ndarray          # (N, nu, nz) feedback gains (for plan reuse)
    cost: jnp.ndarray       # scalar: original (unpenalised) cost
    viol: jnp.ndarray       # scalar: max inequality violation
    iters: jnp.ndarray      # total inner iterations used
    grad_norm: jnp.ndarray  # final max |feedforward|


def _al_penalty(c: jnp.ndarray, lam: jnp.ndarray, mu: jnp.ndarray) -> jnp.ndarray:
    """Powell-Hestenes-Rockafellar penalty for c <= 0."""
    t = jnp.maximum(0.0, lam + mu * c)
    return jnp.sum(t * t - lam * lam) / (2.0 * mu)


def _rollout(ocp: OCPDef, params, z0, V):
    def f(z, v):
        zn = ocp.step(z, v, params)
        return zn, zn

    _, Zs = jax.lax.scan(f, z0, V)
    return jnp.concatenate([z0[None], Zs], axis=0)


def _total_cost(ocp: OCPDef, params, aux, Z, V, lam, mu):
    ks = jnp.arange(V.shape[0])

    def stage(k, z, v, lam_k):
        c = ocp.stage_cost(z, v, k, aux)
        if ocp.n_con:
            c = c + _al_penalty(ocp.constraints(z, v, k, aux), lam_k, mu)
        return c

    cs = jax.vmap(stage)(ks, Z[:-1], V, lam)
    return jnp.sum(cs) + ocp.term_cost(Z[-1], aux)


def _raw_cost(ocp: OCPDef, aux, Z, V):
    ks = jnp.arange(V.shape[0])
    cs = jax.vmap(lambda k, z, v: ocp.stage_cost(z, v, k, aux))(ks, Z[:-1], V)
    return jnp.sum(cs) + ocp.term_cost(Z[-1], aux)


def _linearize(ocp: OCPDef, params, aux, Z, V, lam, mu):
    """Stage-wise Jacobians of dynamics and quadratic expansion of AL cost."""
    ks = jnp.arange(V.shape[0])

    if ocp.dyn_jac is not None:
        def dyn_jac(z, v):
            return ocp.dyn_jac(z, v, params)
    else:
        def dyn_jac(z, v):
            A = jax.jacfwd(ocp.step, argnums=0)(z, v, params)
            B = jax.jacfwd(ocp.step, argnums=1)(z, v, params)
            return A, B

    A, B = jax.vmap(dyn_jac)(Z[:-1], V)

    nz = Z.shape[-1]

    if ocp.cost_quad is not None:
        def cost_quad(k, z, v, lam_k):
            return ocp.cost_quad(k, z, v, lam_k, mu, aux)
    else:
        def cost_quad(k, z, v, lam_k):
            def l_of(zv):
                zz, vv = zv[:nz], zv[nz:]
                c = ocp.stage_cost(zz, vv, k, aux)
                if ocp.n_con:
                    c = c + _al_penalty(ocp.constraints(zz, vv, k, aux),
                                        lam_k, mu)
                return c

            zv = jnp.concatenate([z, v])
            g = jax.grad(l_of)(zv)
            H = jax.hessian(l_of)(zv)
            return g[:nz], g[nz:], H[:nz, :nz], H[nz:, :nz], H[nz:, nz:]

    lx, lu, lxx, lux, luu = jax.vmap(cost_quad)(ks, Z[:-1], V, lam)
    if ocp.term_quad is not None:
        gx, gxx = ocp.term_quad(Z[-1], aux)
    else:
        gx = jax.grad(ocp.term_cost)(Z[-1], aux)
        gxx = jax.hessian(ocp.term_cost)(Z[-1], aux)
    return A, B, lx, lu, lxx, lux, luu, gx, gxx


# Full-precision products: a GPU may otherwise run float32 matmuls in TF32,
# which moves the solutions of these small, badly scaled problems.
mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _backward(derivs, V, u_lo, u_hi, reg):
    """Riccati sweep with per-stage exact box QP (control-limited DDP)."""
    A, B, lx, lu, lxx, lux, luu, gx, gxx = derivs
    nu = V.shape[-1]
    nz = A.shape[-1]
    eye = jnp.eye(nz, dtype=V.dtype)

    def stage(carry, inp):
        Vx, Vxx, dV1, dV2 = carry
        A_k, B_k, lx_k, lu_k, lxx_k, lux_k, luu_k, v_k = inp
        Qx = lx_k + mm(A_k.T, Vx)
        Qu = lu_k + mm(B_k.T, Vx)
        Vxx_reg = Vxx + reg * eye
        Qxx = lxx_k + mm(mm(A_k.T, Vxx), A_k)
        Qux = lux_k + mm(mm(B_k.T, Vxx_reg), A_k)
        Quu = luu_k + mm(mm(B_k.T, Vxx_reg), B_k)
        Quu = 0.5 * (Quu + Quu.T) + 1e-9 * jnp.eye(nu, dtype=V.dtype)

        lo = u_lo - v_k
        hi = u_hi - v_k
        d, free = boxqp(Quu, Qu, lo, hi)
        # Feedback only on free dims: solve Quu_ff K_f = -Qux_f.
        H = Quu * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
        K = -jnp.linalg.solve(H, Qux * free[:, None])

        Vx_n = Qx + mm(mm(K.T, Quu), d) + mm(K.T, Qu) + mm(Qux.T, d)
        Vxx_n = Qxx + mm(mm(K.T, Quu), K) + mm(K.T, Qux) + mm(Qux.T, K)
        Vxx_n = 0.5 * (Vxx_n + Vxx_n.T)
        dV1_n = dV1 + mm(Qu, d)
        dV2_n = dV2 + 0.5 * mm(mm(d, Quu), d)
        return (Vx_n, Vxx_n, dV1_n, dV2_n), (d, K)

    init = (gx, gxx, jnp.zeros((), V.dtype), jnp.zeros((), V.dtype))
    (_, _, dV1, dV2), (D, Ks) = jax.lax.scan(
        stage, init, (A, B, lx, lu, lxx, lux, luu, V), reverse=True
    )
    return D, Ks, dV1, dV2


def _forward(ocp, params, aux, Z, V, D, Ks, lam, mu, alpha, u_lo, u_hi):
    """Closed-loop rollout with clamped controls at step length alpha."""
    def f(z, inp):
        z_ref, v_ref, d, K = inp
        v = jnp.clip(v_ref + alpha * d + mm(K, z - z_ref), u_lo, u_hi)
        zn = ocp.step(z, v, params)
        return zn, (zn, v)

    _, (Zs, Vn) = jax.lax.scan(f, Z[0], (Z[:-1], V, D, Ks))
    Zn = jnp.concatenate([Z[:1], Zs], axis=0)
    cost = _total_cost(ocp, params, aux, Zn, Vn, lam, mu)
    return Zn, Vn, cost


def _ilqr_inner(ocp: OCPDef, cfg: ILQRConfig, params, aux, z0, V0, lam, mu):
    """Run iLQR to convergence on the AL-augmented objective (jit-safe)."""
    Z0 = _rollout(ocp, params, z0, V0)
    cost0 = _total_cost(ocp, params, aux, Z0, V0, lam, mu)
    alphas = jnp.power(0.6, jnp.arange(cfg.n_alphas)).astype(V0.dtype)
    u_lo = jnp.asarray(ocp.u_lo, V0.dtype)
    u_hi = jnp.asarray(ocp.u_hi, V0.dtype)

    def cond(carry):
        _, _, _, _, it, done, _, _ = carry
        return (it < cfg.max_iters) & (~done)

    def linesearch_parallel(Z, V, D, Ks, cost):
        Zc, Vc, costs = jax.vmap(
            lambda a: _forward(ocp, params, aux, Z, V, D, Ks, lam, mu, a,
                               u_lo, u_hi)
        )(alphas)
        best = jnp.argmin(costs)
        return Zc[best], Vc[best], costs[best]

    def linesearch_backtrack(Z, V, D, Ks, cost):
        def cond(c):
            i, accepted, _, _, _ = c
            return (i < cfg.n_alphas) & (~accepted)

        def body(c):
            i, _, Zb, Vb, cb = c
            Zc, Vc, cost_c = _forward(ocp, params, aux, Z, V, D, Ks, lam, mu,
                                      alphas[i], u_lo, u_hi)
            accept = cost_c < cost - 1e-12
            Zb = jnp.where(accept, Zc, Zb)
            Vb = jnp.where(accept, Vc, Vb)
            cb = jnp.where(accept, cost_c, cb)
            return (i + 1, accept, Zb, Vb, cb)

        _, _, Zb, Vb, cb = jax.lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32), jnp.zeros((), bool),
                         Z, V, cost))
        return Zb, Vb, cb

    ls = (linesearch_backtrack if cfg.linesearch == "backtrack"
          else linesearch_parallel)

    def body(carry):
        Z, V, K_prev, cost, it, _, reg, gnorm = carry
        derivs = _linearize(ocp, params, aux, Z, V, lam, mu)
        D, Ks, dV1, dV2 = _backward(derivs, V, u_lo, u_hi, reg)

        Z_best, V_best, cost_new = ls(Z, V, D, Ks, cost)
        improved = cost_new < cost - 1e-12
        Z_n = jnp.where(improved, Z_best, Z)
        V_n = jnp.where(improved, V_best, V)
        K_n = jnp.where(improved, Ks, K_prev)
        reg_n = jnp.where(
            improved,
            jnp.maximum(reg * cfg.reg_down, cfg.reg_min),
            jnp.minimum(reg * cfg.reg_up, cfg.reg_max),
        )
        gnorm_n = jnp.max(jnp.abs(D))
        rel_decrease = (cost - cost_new) / (jnp.abs(cost) + 1.0)
        done = (improved & (rel_decrease < cfg.tol_cost)) | \
               (gnorm_n < cfg.tol_step) | \
               ((~improved) & (reg >= cfg.reg_max))
        cost_keep = jnp.where(improved, cost_new, cost)
        return (Z_n, V_n, K_n, cost_keep, it + 1, done, reg_n, gnorm_n)

    K_init = jnp.zeros((V0.shape[0], V0.shape[1], Z0.shape[1]), V0.dtype)
    init = (Z0, V0, K_init, cost0, jnp.zeros((), jnp.int32),
            jnp.zeros((), bool), jnp.asarray(cfg.reg_init, V0.dtype),
            jnp.asarray(jnp.inf, V0.dtype))
    Z, V, K, cost, it, _, _, gnorm = jax.lax.while_loop(cond, body, init)
    return Z, V, K, cost, it, gnorm


def _batch_axes(tree, B: int):
    """vmap in_axes for a params/aux pytree: leaves whose LEADING dim == B
    are treated as batched, everything else broadcast. Caveat: a SHARED
    leaf whose first dimension coincidentally equals the batch size is
    misclassified — callers of the batched APIs must batch every leaf (as
    all in-repo callers do) or avoid B-sized leading dims on shared data.
    """
    return jax.tree.map(
        lambda x: 0 if (hasattr(x, "ndim") and getattr(x, "ndim", 0) >= 1
                        and x.shape[0] == B) else None, tree)


@functools.partial(jax.jit, static_argnames=("ocp", "cfg"))
def solve_batch(ocp: OCPDef, cfg: ILQRConfig, params, aux, z0: jnp.ndarray,
                V_init: jnp.ndarray):
    """Batch-major unconstrained solve (PMPC/LMPC-style OCPs, n_con == 0).

    Linearisation, backward pass and line search are vmapped over the
    batch, with whole-batch control flow. Per-lane regularisation,
    acceptance and convergence masks reproduce `solve`'s control flow, and
    constrained OCPs (n_con > 0) run the augmented-Lagrangian outer loop
    with per-lane multipliers/penalties.

    Args: params/aux batched pytrees, z0 (B, nz), V_init (B, N, nu).
    Returns a batched ILQRSolution (without multiplier info).
    """
    B, N, nu = V_init.shape
    dtype = V_init.dtype
    u_lo = jnp.asarray(ocp.u_lo, dtype)
    u_hi = jnp.asarray(ocp.u_hi, dtype)
    V = jnp.clip(V_init, u_lo, u_hi)
    n_con = max(ocp.n_con, 1)   # placeholder width when unconstrained

    # Map only leaves that actually carry the batch axis (scalar params like
    # a shared dt broadcast automatically) — see _batch_axes caveat.
    p_ax = _batch_axes(params, B)
    a_ax = _batch_axes(aux, B)

    roll_v = jax.vmap(lambda p, z, v: _rollout(ocp, p, z, v),
                      in_axes=(p_ax, 0, 0))
    cost_v = jax.vmap(lambda p, a, Z, Vv, lam, mu: _total_cost(
        ocp, p, a, Z, Vv, lam, mu),
        in_axes=(p_ax, a_ax, 0, 0, 0, 0))
    lin_v = jax.vmap(lambda p, a, Z, Vv, lam, mu: _linearize(
        ocp, p, a, Z, Vv, lam, mu),
        in_axes=(p_ax, a_ax, 0, 0, 0, 0))
    raw_v = jax.vmap(lambda a, Z, Vv: _raw_cost(ocp, a, Z, Vv),
                     in_axes=(a_ax, 0, 0))

    def backward(derivs, V, reg):
        D, K, _, _ = jax.vmap(
            lambda d, v, r: _backward(d, v, u_lo, u_hi, r))(derivs, V, reg)
        return D, K

    fwd_v = jax.vmap(lambda p, a, Z, Vv, D, K, lam, mu, al: _forward(
        ocp, p, a, Z, Vv, D, K, lam, mu, al, u_lo, u_hi),
        in_axes=(p_ax, a_ax, 0, 0, 0, 0, 0, 0, 0))

    alphas = jnp.power(0.6, jnp.arange(cfg.n_alphas)).astype(dtype)

    def inner(V, lam, mu):
        """Batched iLQR on the AL objective for fixed (lam, mu)."""
        Z0 = roll_v(params, z0, V)
        cost0 = cost_v(params, aux, Z0, V, lam, mu)

        def cond(c):
            _, _, _, _, it, done, _, _ = c
            return (it < cfg.max_iters) & (~jnp.all(done))

        def body(c):
            Z, V, K_prev, cost, it, done, reg, gnorm = c
            derivs = lin_v(params, aux, Z, V, lam, mu)
            D, Ks = backward(derivs, V, reg)

            # Per-lane backtracking: each lane advances its own alpha index
            # until it accepts or exhausts the schedule.
            def ls_cond(st):
                i, acc, _, _, _ = st
                return (i < cfg.n_alphas) & (~jnp.all(acc))

            def ls_body(st):
                i, acc, Zb, Vb, cb = st
                al = jnp.full((B,), alphas[i], dtype)
                Zc, Vc, cc = fwd_v(params, aux, Z, V, D, Ks, lam, mu, al)
                newly = (~acc) & (cc < cost - 1e-12)
                Zb = jnp.where(newly[:, None, None], Zc, Zb)
                Vb = jnp.where(newly[:, None, None], Vc, Vb)
                cb = jnp.where(newly, cc, cb)
                return (i + 1, acc | newly, Zb, Vb, cb)

            _, improved, Z_b, V_b, cost_new = jax.lax.while_loop(
                ls_cond, ls_body,
                (jnp.zeros((), jnp.int32), done, Z, V, cost))
            improved = improved & (~done)

            Z_n = jnp.where(improved[:, None, None], Z_b, Z)
            V_n = jnp.where(improved[:, None, None], V_b, V)
            K_n = jnp.where(improved[:, None, None, None], Ks, K_prev)
            reg_n = jnp.where(improved,
                              jnp.maximum(reg * cfg.reg_down, cfg.reg_min),
                              jnp.minimum(reg * cfg.reg_up, cfg.reg_max))
            gnorm_n = jnp.max(jnp.abs(D), axis=(1, 2))
            cost_keep = jnp.where(improved, cost_new, cost)
            rel = (cost - cost_keep) / (jnp.abs(cost) + 1.0)
            done_n = done | (improved & (rel < cfg.tol_cost)) | \
                (gnorm_n < cfg.tol_step) | ((~improved) & (reg >= cfg.reg_max))
            return (Z_n, V_n, K_n, cost_keep, it + 1, done_n, reg_n, gnorm_n)

        K0 = jnp.zeros((B, N, nu, Z0.shape[-1]), dtype)
        init = (Z0, V, K0, cost0, jnp.zeros((), jnp.int32),
                jnp.zeros((B,), bool), jnp.full((B,), cfg.reg_init, dtype),
                jnp.full((B,), jnp.inf, dtype))
        Z, V, K, cost, it, done, reg, gnorm = jax.lax.while_loop(
            cond, body, init)
        return Z, V, K, it, gnorm

    if ocp.n_con == 0:
        lam0 = jnp.zeros((B, N, 1), dtype)
        mu0 = jnp.ones((B,), dtype)
        Z, V, K, it, gnorm = inner(V, lam0, mu0)
        raw = raw_v(aux, Z, V)
        return ILQRSolution(V=V, Z=Z, K=K, cost=raw,
                            viol=jnp.zeros((B,), dtype),
                            iters=jnp.broadcast_to(it, (B,)),
                            grad_norm=gnorm)

    # Augmented-Lagrangian outer loop, per-lane multipliers/penalties.
    con_v = jax.vmap(
        lambda a, Z, Vv: jax.vmap(
            lambda k, z, v: ocp.constraints(z, v, k, a))(
                jnp.arange(N), Z[:-1], Vv),
        in_axes=(a_ax, 0, 0))

    def al_round(carry, _):
        V, lam, mu, viol_prev, tot_it = carry
        Z, V_n, K, it, gnorm = inner(V, lam, mu)
        C = con_v(aux, Z, V_n)                       # (B, N, n_con)
        lam_n = jnp.maximum(0.0, lam + mu[:, None, None] * C)
        viol = jnp.max(jnp.maximum(C, 0.0), axis=(1, 2))
        mu_n = jnp.where(viol > cfg.tol_con,
                         jnp.minimum(mu * cfg.mu_scale, cfg.mu_max), mu)
        return (V_n, lam_n, mu_n, viol, tot_it + it), (Z, K, gnorm)

    lam0 = jnp.zeros((B, N, ocp.n_con), dtype)
    init = (V, lam0, jnp.full((B,), cfg.mu_init, dtype),
            jnp.full((B,), jnp.inf, dtype), jnp.zeros((), jnp.int32))
    (V, lam, mu, viol, tot_it), (Zs, Ks, gnorms) = jax.lax.scan(
        al_round, init, None, length=cfg.al_iters)
    Z = Zs[-1]
    raw = raw_v(aux, Z, V)
    return ILQRSolution(V=V, Z=Z, K=Ks[-1], cost=raw, viol=viol,
                        iters=jnp.broadcast_to(tot_it, (B,)),
                        grad_norm=gnorms[-1])


def projected_grad_norm(ocp: OCPDef, params, aux, z0: jnp.ndarray,
                        V: jnp.ndarray) -> jnp.ndarray:
    """Per-lane first-order stationarity of the RAW objective at V:
    max |V - clip(V - dJ/dV, u_lo, u_hi)| over the horizon.

    Zero at a box-constrained optimum; the post-hoc convergence diagnostic
    for the fixed-budget whole-solve kernel paths (which cannot surface
    their internal feedforward norms) — one vjp through the rollout, pure
    XLA, so it composes with any solver. Inequality-constrained OCPs should
    additionally check the kernel-reported `viol`.

    Args: params/aux pytrees with leading batch axes where batched,
    z0 (B, nz), V (B, N, nu). Returns (B,).
    """
    B = V.shape[0]
    u_lo = jnp.asarray(ocp.u_lo, V.dtype)
    u_hi = jnp.asarray(ocp.u_hi, V.dtype)

    def J(p, a, z, v):
        Z = _rollout(ocp, p, z, v)
        return _raw_cost(ocp, a, Z, v)

    g = jax.vmap(jax.grad(J, argnums=3),
                 in_axes=(_batch_axes(params, B), _batch_axes(aux, B), 0, 0))(
                     params, aux, z0, V)
    step = jnp.clip(V - g, u_lo, u_hi) - V
    return jnp.max(jnp.abs(step), axis=(1, 2))


def constraint_max(ocp: OCPDef, params, aux, z0: jnp.ndarray,
                   V: jnp.ndarray) -> jnp.ndarray:
    """Per-lane max RAW constraint value (signed: negative = strictly
    feasible/inactive) along the trajectory induced by V. Companion to
    `projected_grad_norm`: where constraints are strictly inactive the raw
    projected gradient is a valid stationarity test; where they are active
    the AL gradient differs from the raw one and feasibility (`viol`) is
    the criterion instead. Returns (B,)."""
    B, N = V.shape[0], V.shape[1]

    def cmax(p, a, z, v):
        Z = _rollout(ocp, p, z, v)
        C = jax.vmap(lambda k, zk, vk: ocp.constraints(zk, vk, k, a))(
            jnp.arange(N), Z[:-1], v)
        return jnp.max(C)

    return jax.vmap(cmax,
                    in_axes=(_batch_axes(params, B), _batch_axes(aux, B),
                             0, 0))(params, aux, z0, V)


@functools.partial(jax.jit, static_argnames=("ocp", "cfg"))
def solve(ocp: OCPDef, cfg: ILQRConfig, params, aux, z0: jnp.ndarray,
          V_init: jnp.ndarray) -> ILQRSolution:
    """Solve one OCP. vmap over (params, aux, z0, V_init) for batches.

    `ocp` and `cfg` are static (hashable NamedTuples of callables/floats);
    all numeric inputs are traced.
    """
    N = V_init.shape[0]
    dtype = V_init.dtype
    V = jnp.clip(V_init, jnp.asarray(ocp.u_lo, dtype), jnp.asarray(ocp.u_hi, dtype))

    if ocp.n_con == 0:
        lam = jnp.zeros((N, 1), dtype)  # unused placeholder
        Z, V, K, _, it, gnorm = _ilqr_inner(
            ocp, cfg, params, aux, z0, V, lam, jnp.asarray(1.0, dtype))
        raw = _raw_cost(ocp, aux, Z, V)
        return ILQRSolution(V, Z, K, raw, jnp.zeros((), dtype), it, gnorm)

    lam0 = jnp.zeros((N, ocp.n_con), dtype)

    def al_round(carry, _):
        V, lam, mu, viol_prev, tot_it = carry
        Z, V_n, K, _, it, gnorm = _ilqr_inner(ocp, cfg, params, aux, z0, V, lam, mu)
        ks = jnp.arange(N)
        C = jax.vmap(lambda k, z, v: ocp.constraints(z, v, k, aux))(ks, Z[:-1], V_n)
        lam_n = jnp.maximum(0.0, lam + mu * C)
        viol = jnp.max(jnp.maximum(C, 0.0)) if C.size else jnp.zeros((), dtype)
        mu_n = jnp.where(viol > cfg.tol_con,
                         jnp.minimum(mu * cfg.mu_scale, cfg.mu_max), mu)
        return (V_n, lam_n, mu_n, viol, tot_it + it), (Z, K, viol, gnorm)

    init = (V, lam0, jnp.asarray(cfg.mu_init, dtype),
            jnp.asarray(jnp.inf, dtype), jnp.zeros((), jnp.int32))
    (V, lam, mu, viol, tot_it), (Zs, Ks, viols, gnorms) = jax.lax.scan(
        al_round, init, None, length=cfg.al_iters)
    Z = Zs[-1]
    K = Ks[-1]
    raw = _raw_cost(ocp, aux, Z, V)
    return ILQRSolution(V, Z, K, raw, viol, tot_it, gnorms[-1])
