"""The complete fixed-budget RMPC solve — AL outer loop included — as one
batched program of lane algebra.

RMPC is the adaptive variant (`RMPC/dev_dual/controller/
np_mpc_adaptive_with_linear_regressor.py:34-222` in the reference): an
nx=4 / nu=2 OCP over the gravity + 7-feature-regressor model whose theta is
tuned online by RLS, tracking a staged reference trajectory, with slew-rate
and velocity-cap constraints (IPOPT, 200-iteration budget). Here the whole
constrained solve is one batched program with the scenarios on the trailing
axis (`ops.lanes`), run by XLA, in the slew-exact formulation
(`solver.ocp.make_rmpc_ocp_du`):

- decision variable v = du with box bounds (+-du_bound) handled EXACTLY by
  per-stage 2x2 box QPs; applied tilt u = clip(u_prev + v, +-u_bound);
- velocity caps |vx|,|vy| <= vmax as augmented-Lagrangian constraints with
  per-lane multipliers lam (N,4,L) and penalty mu — the same PHR update as
  `solver.ilqr.solve_batch`'s outer loop;
- hand-derived closed-form RK4 linearisation (`models.dynamics.rmpc_jac` /
  `rk4_jac`, pinned to autodiff by `tests/test_structure.py`);
- Riccati backward PARTITIONED over the augmented state z = [x(4), u(2)]:
  with A = [[Ad, Bm], [0, Dm]] and B = [[Bm], [Dm]] (Dm = diag of the clip
  pass-through mask), the value Hessian splits into P (4,4), q (4,2),
  r (2,2) and every product touches only the structural nonzeros;
- multi-alpha line search on the AL-penalised cost with per-lane acceptance
  and convergence masks, reset per AL round (matching `solve_batch`).

Inputs (batch on the last axis, L lanes):
  theta (14, L)       RLS estimates [theta_x(7), theta_y(7)]
  ref   (N+1, 4, L)   staged reference trajectory (`build_ref_traj`)
  w     (4, L)        [Qp, Qv, Ru, Rdu]
  z0    (6, L)        [x0(4), u_prev(2)]
  V0    (N, 2, L)     warm start (du sequence)
Outputs: V (N, 2, L), cost (L,) raw (unpenalised), viol (L,), gnorm (L,).

Reg-free like the PMPC/LMPC bodies: the Gauss-Newton stage Hessians are
PSD by construction (diagonal state costs, PHR penalty curvature >= 0) and
Qvv >= 2*Rdu > 0; a 1e-8 jitter guards the 2x2 inverses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dart_tpu.ops.lanes import (add_diag_vec, boxqp2_stacked, gains2_stacked,
                                mm, mT, mv, rk4_jac)
_G = -9.81   # signed, like model.opt.gravity[2] (`rob_ctrl.py:281`)


def _rmpc_body(N, n_iters, n_alphas, al_rounds, dt, u_b, du_b, vmax, v_eps,
               mu_init, mu_scale, mu_max, tol_con, roll_loops,
               th, ref, wv, z0, V):
    Qp, Qv, Ru, Rdu = wv[0], wv[1], wv[2], wv[3]
    w4 = jnp.stack([Qp, Qv, Qp, Qv])            # (4, L)
    x0 = z0[0:4]
    up0 = z0[4:6]

    def f4(x, u):
        """xdot (4, L) — lane transcription of `models.dynamics.rmpc_dynamics`."""
        px, vx, py, vy = x[0], x[1], x[2], x[3]
        a, b = u[0], u[1]
        tx = jnp.tanh(vx / v_eps)
        ty = jnp.tanh(vy / v_eps)
        # phi = [px, vx, py, vy, tanh(vx/eps), tanh(vy/eps), 1]
        ax = (_G * jnp.sin(a) + th[0] * px + th[1] * vx + th[2] * py
              + th[3] * vy + th[4] * tx + th[5] * ty + th[6])
        ay = (_G * jnp.sin(b) + th[7] * px + th[8] * vx + th[9] * py
              + th[10] * vy + th[11] * tx + th[12] * ty + th[13])
        return jnp.stack([vx, ax, vy, ay])

    def jac4(x, u):
        """Continuous-time (A (4,4,L), B (4,2,L)) — `models.dynamics.rmpc_jac`."""
        vx, vy = x[1], x[3]
        a, b = u[0], u[1]
        tx = jnp.tanh(vx / v_eps)
        ty = jnp.tanh(vy / v_eps)
        dtx = (1.0 - tx * tx) / v_eps
        dty = (1.0 - ty * ty) / v_eps
        z = jnp.zeros_like(vx)
        o = jnp.ones_like(vx)
        r_ax = [th[0], th[1] + th[4] * dtx, th[2], th[3] + th[5] * dty]
        r_ay = [th[7], th[8] + th[11] * dtx, th[9], th[10] + th[12] * dty]
        A = jnp.stack([jnp.stack([z, o, z, z]), jnp.stack(r_ax),
                       jnp.stack([z, z, z, o]), jnp.stack(r_ay)])
        ca = _G * jnp.cos(a)
        cb = _G * jnp.cos(b)
        B = jnp.stack([jnp.stack([z, z]), jnp.stack([ca, z]),
                       jnp.stack([z, z]), jnp.stack([z, cb])])
        return A, B

    def rk4(x, u):
        k1 = f4(x, u)
        k2 = f4(x + 0.5 * dt * k1, u)
        k3 = f4(x + 0.5 * dt * k2, u)
        k4 = f4(x + dt * k3, u)
        return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def con4(x):
        """Velocity caps c(x) <= 0 (`np_mpc...py:124-127`), (4, L)."""
        return jnp.stack([x[1] - vmax, -x[1] - vmax,
                          x[3] - vmax, -x[3] - vmax])

    def stage_cost_al(x, up, v, ref_k, lam_k, mu):
        """AL-penalised stage cost (`make_rmpc_ocp_du.stage_cost` + PHR)."""
        u = jnp.clip(up + v, -u_b, u_b)
        e = x - ref_k
        c = (jnp.sum(w4 * e * e, axis=0)
             + Ru * (u[0] * u[0] + u[1] * u[1])
             + Rdu * (v[0] * v[0] + v[1] * v[1]))
        t = jnp.maximum(0.0, lam_k + mu * con4(x))
        return c + jnp.sum(t * t - lam_k * lam_k, axis=0) / (2.0 * mu)

    def terminal_cost(x):
        e = x - ref[N]
        return jnp.sum(w4 * e * e, axis=0)

    def with_start(first, rest):
        return jnp.concatenate([first[None], rest])

    # Every stage loop is a `lax.scan` over the horizon, so the compiled
    # program holds one copy of each stage body whatever N is.
    def rollout_cost(V, lam, mu):
        def stage(c, inp):
            x, up, cost = c
            v, ref_k, lam_k = inp
            cost = cost + stage_cost_al(x, up, v, ref_k, lam_k, mu)
            u = jnp.clip(up + v, -u_b, u_b)
            x = rk4(x, u)
            return (x, u, cost), (x, u)

        (xN, _, cost), (xs, us) = jax.lax.scan(
            stage, (x0, up0, jnp.zeros_like(Qp)), (V, ref[:N], lam))
        return (with_start(x0, xs), with_start(up0, us),
                cost + terminal_cost(xN))       # (N+1,4,L), (N+1,2,L)

    alphas = [0.6 ** i for i in range(n_alphas)]

    def iteration(carry, lam, mu):
        X, U, V, cost, done, _ = carry

        # ---- backward: partitioned Riccati over z = [x(4), u_prev(2)] ----
        zl = jnp.zeros_like(Qp)

        def backward_stage(c, inp):
            vx4, vu2, P, q, r = c
            x, up, v_k, ref_k, lam_k = inp
            s = up + v_k
            m = (jnp.abs(s) < u_b).astype(Qp.dtype)        # clip mask (2, L)
            u = jnp.clip(s, -u_b, u_b)
            Ad, Bd = rk4_jac(f4, jac4, x, u, dt)
            Bm = Bd * m[None]                              # (4, 2, L)

            # Stage cost quadratics (`make_rmpc_ocp_du.cost_quad`).
            e = x - ref_k
            gu = 2.0 * Ru * u * m                          # (2, L)
            hu = 2.0 * Ru * m
            e4 = 2.0 * w4 * e
            lv = 2.0 * Rdu * v_k + gu
            # PHR velocity-cap rows (Jacobian rows +-e1, +-e3).
            t = jnp.maximum(0.0, lam_k + mu * con4(x))
            act = (t > 0).astype(Qp.dtype)
            lx4 = jnp.stack([e4[0], e4[1] + t[0] - t[1],
                             e4[2], e4[3] + t[2] - t[3]])
            diag_al = jnp.stack([zl, mu * (act[0] + act[1]),
                                 zl, mu * (act[2] + act[3])])

            AdT = mT(Ad)
            BmT = mT(Bm)
            core = mv(BmT, vx4) + m * vu2                 # (2, L)
            Qx4 = lx4 + mv(AdT, vx4)
            Qu2 = gu + core
            Qvl = lv + core

            PB = mm(P, Bm)                                # (4, 2, L)
            qD = q * m[None]                               # (4, 2, L)
            W = PB + qD
            S1 = mT(W)                                    # (2, 4, L)
            S2 = mm(BmT, q) + r * m[:, None]              # (2, 2, L)
            Qxx11 = add_diag_vec(mm(mm(AdT, P), Ad), 2.0 * w4 + diag_al)
            Qxx12 = mm(AdT, W)                            # (4, 2, L)
            G = mm(S1, Bm) + S2 * m[None]                 # (2, 2, L)
            Qvz1 = mm(S1, Ad)                             # (2, 4, L)
            Qvz2 = add_diag_vec(G, hu)                    # (2, 2, L)
            Qxx22 = Qvz2
            Qvv = add_diag_vec(G, 2.0 * Rdu + hu + 1e-8)
            Qvv = 0.5 * (Qvv + mT(Qvv))

            lo = -du_b - v_k
            hi = du_b - v_k
            d, free = boxqp2_stacked(Qvv, Qvl, lo, hi)
            gn = jnp.maximum(jnp.abs(d[0]), jnp.abs(d[1]))
            cols = gains2_stacked(
                Qvv, free,
                [(Qvz1[0, j], Qvz1[1, j]) for j in range(4)]
                + [(Qvz2[0, j], Qvz2[1, j]) for j in range(2)])
            K1 = jnp.stack([jnp.stack([c[0] for c in cols[:4]]),
                            jnp.stack([c[1] for c in cols[:4]])])   # (2,4,L)
            K2 = jnp.stack([jnp.stack([c[0] for c in cols[4:]]),
                            jnp.stack([c[1] for c in cols[4:]])])   # (2,2,L)

            w2 = mv(Qvv, d) + Qvl
            vx4 = Qx4 + mv(mT(K1), w2) + mv(mT(Qvz1), d)
            vu2 = Qu2 + mv(mT(K2), w2) + mv(mT(Qvz2), d)
            K1T_Qvv = mm(mT(K1), Qvv)                    # (4, 2, L)
            M1 = mm(mT(K1), Qvz1)                        # (4, 4, L)
            P = Qxx11 + mm(K1T_Qvv, K1) + M1 + mT(M1)
            P = 0.5 * (P + mT(P))
            q = (Qxx12 + mm(K1T_Qvv, K2) + mm(mT(K1), Qvz2)
                 + mm(mT(Qvz1), K2))
            K2T_Qvv = mm(mT(K2), Qvv)
            M2 = mm(mT(K2), Qvz2)
            r = Qxx22 + mm(K2T_Qvv, K2) + M2 + mT(M2)
            r = 0.5 * (r + mT(r))
            return (vx4, vu2, P, q, r), (d, K1, K2, gn)

        init = (2.0 * w4 * (X[N] - ref[N]), jnp.zeros_like(up0),
                add_diag_vec(jnp.stack([jnp.stack([zl] * 4)] * 4), 2.0 * w4),
                jnp.stack([jnp.stack([zl] * 2)] * 4),    # q (4, 2, L)
                jnp.stack([jnp.stack([zl] * 2)] * 2))    # r (2, 2, L)
        _, (Ds, K1s, K2s, gns) = jax.lax.scan(
            backward_stage, init, (X[:N], U[:N], V, ref[:N], lam),
            reverse=True)

        # ---- forward line search with per-lane acceptance ----
        def forward(al):
            def stage(c, inp):
                x, up, cost = c
                v_ref, d, K1, K2, x_ref, up_ref, ref_k, lam_k = inp
                v = (v_ref + al * d + mv(K1, x - x_ref)
                     + mv(K2, up - up_ref))
                v = jnp.clip(v, -du_b, du_b)
                cost = cost + stage_cost_al(x, up, v, ref_k, lam_k, mu)
                u = jnp.clip(up + v, -u_b, u_b)
                x = rk4(x, u)
                return (x, u, cost), (x, u, v)

            (xN, _, cost), (xs, us, vs) = jax.lax.scan(
                stage, (x0, up0, jnp.zeros_like(Qp)),
                (V, Ds, K1s, K2s, X[:N], U[:N], ref[:N], lam))
            return (with_start(x0, xs), with_start(up0, us), vs,
                    cost + terminal_cost(xN))

        accepted = done
        X_best, U_best, V_best, c_best = X, U, V, cost
        for al in alphas:
            X_new, U_new, V_new, c_new = forward(al)
            newly = (~accepted) & (c_new < cost - 1e-12)
            m3 = newly[None, None, :]
            X_best = jnp.where(m3, X_new, X_best)
            U_best = jnp.where(m3, U_new, U_best)
            V_best = jnp.where(m3, V_new, V_best)
            c_best = jnp.where(newly, c_new, c_best)
            accepted = accepted | newly

        rel = (cost - c_best) / (jnp.abs(cost) + 1.0)
        done_n = done | (accepted & (rel < 1e-9)) | (~accepted)
        return (X_best, U_best, V_best, c_best, done_n, jnp.max(gns, axis=0))

    # ---- augmented-Lagrangian outer loop (per-lane lam/mu) ----
    # Compile-time control: small budgets unroll; robust budgets roll BOTH
    # loops with fori_loop, so the compiler sees one iteration body and one
    # AL-round body instead of al_rounds*n_iters copies. Identical
    # per-element op sequence either way.
    roll = (n_iters * al_rounds > 4) if roll_loops is None else roll_loops

    def al_round(al_carry):
        V, lam, mu, _, _ = al_carry
        X, U, cost = rollout_cost(V, lam, mu)
        done = jnp.zeros_like(cost, dtype=jnp.bool_)
        carry = (X, U, V, cost, done, jnp.zeros_like(cost))
        if roll:
            carry = jax.lax.fori_loop(
                0, n_iters, lambda _, c: iteration(c, lam, mu), carry)
        else:
            for _ in range(n_iters):
                carry = iteration(carry, lam, mu)
        X, U, V, cost, _, gnorm = carry
        # PHR multiplier update on the round's final trajectory
        # (`ilqr.solve_batch` al_round; constraints at stages 0..N-1).
        C = jax.vmap(con4)(X[:N])                          # (N, 4, L)
        lam = jnp.maximum(0.0, lam + mu * C)
        viol = jnp.max(jnp.maximum(C, 0.0), axis=(0, 1))
        mu = jnp.where(viol > tol_con, jnp.minimum(mu * mu_scale, mu_max), mu)
        return (V, lam, mu, viol, gnorm)

    lam = jnp.stack([jnp.stack([jnp.zeros_like(Qp)] * 4)] * N)  # (N, 4, L)
    mu = jnp.full_like(Qp, mu_init)
    al_carry = (V, lam, mu, jnp.zeros_like(Qp), jnp.zeros_like(Qp))
    if roll:
        al_carry = jax.lax.fori_loop(0, al_rounds,
                                     lambda _, c: al_round(c), al_carry)
    else:
        for _ in range(al_rounds):
            al_carry = al_round(al_carry)
    V, lam, mu, viol, gnorm = al_carry

    # Raw (unpenalised) cost of the final iterate.
    def raw_stage(c, inp):
        x, up, raw = c
        v, ref_k = inp
        u = jnp.clip(up + v, -u_b, u_b)
        e = x - ref_k
        raw = raw + (jnp.sum(w4 * e * e, axis=0)
                     + Ru * (u[0] * u[0] + u[1] * u[1])
                     + Rdu * (v[0] ** 2 + v[1] ** 2))
        return (rk4(x, u), u, raw), None

    (xN, _, raw), _ = jax.lax.scan(raw_stage, (x0, up0, jnp.zeros_like(Qp)),
                                   (V, ref[:N]))
    raw = raw + terminal_cost(xN)

    # gnorm: max |feedforward| of the last AL round's last iteration — the
    # AL-merit analogue of the generic solver's grad_norm.
    return V, raw, viol, gnorm


@functools.partial(jax.jit, static_argnames=(
    "dt", "u_bound", "du_bound", "vmax", "v_eps", "n_iters", "n_alphas",
    "al_rounds", "mu_init", "mu_scale", "mu_max", "tol_con", "roll_loops"))
def rmpc_solve(theta, ref, w, z0, V0, dt: float, u_bound: float = 0.4,
               du_bound: float = 0.05, vmax: float = 0.25, v_eps: float = 0.1,
               n_iters: int = 2, n_alphas: int = 3, al_rounds: int = 2,
               mu_init: float = 10.0, mu_scale: float = 10.0,
               mu_max: float = 1e8, tol_con: float = 1e-8, roll_loops=None):
    """Batch-last layout: theta (14,B), ref (N+1,4,B), w (4,B) =
    [Qp,Qv,Ru,Rdu], z0 (6,B), V0 (N,2,B).
    Returns (V (N,2,B) du sequence, cost, viol, gnorm (B,) each)."""
    dtype = V0.dtype
    return _rmpc_body(V0.shape[0], n_iters, n_alphas, al_rounds, dt, u_bound,
                      du_bound, vmax, v_eps, mu_init, mu_scale, mu_max,
                      tol_con, roll_loops, theta.astype(dtype),
                      ref.astype(dtype), w.astype(dtype), z0.astype(dtype),
                      jnp.clip(V0, -du_bound, du_bound))
