"""The complete fixed-budget LMPC solve as one batched program of lane
algebra.

LMPC is the learning-enhanced variant (`LMPC/src/controller/rlmpc2.py:236-533`
in the reference): an nx=8 / nu=2 OCP over the 34-parameter Stribeck /
rolling / toppling model whose parameters are tuned online by PPO. The
reference solves it with IPOPT in a worker process under a 50 ms budget;
here the whole box-DDP solve — rollout, hand-derived closed-form RK4
linearisation (`models.dynamics.lmpc_jac` / `rk4_jac`, pinned to autodiff by
`tests/test_structure.py`), partitioned Riccati backward with exact 2x2 box
QPs, multi-alpha line search, fixed iteration count with per-lane
convergence masks — is one batched program with the scenarios on the
trailing axis (`ops.lanes`), run by XLA.

State layout: the solver state is augmented, z = [x(8), u_prev(2)] (the du
move-suppression cost needs u_prev; see `solver.ocp.make_lmpc_ocp`). The
Riccati recursion is PARTITIONED over that block structure instead of
running dense 10x10 lane algebra: with A = [[Ad, 0], [0, 0]] and
B = [[Bd], [I2]], the value Hessian splits into P (8,8), q (8,2), r (2,2)
and every product touches only the nonzero blocks (~40% fewer lane FMAs
than the dense form).

Inputs (batch on the last axis, L lanes):
  pvec   (34, L)      raw model parameters (squash applied in the body)
  Q      (8, L)       stage state cost diagonal
  R      (4, L)       [Ru0, Ru1, Rdu0, Rdu1]
  Qt     (8, L)       terminal state cost diagonal
  target (8, L)
  z0     (10, L)      [x0, u_prev]
  V0     (N, 2, L)    warm start
Outputs: V (N, 2, L), cost (L,), gnorm (L,).

Reg-free like the PMPC body: the stage cost's (z, v) Hessian is PSD by
construction and the recursion is Gauss-Newton, so Vxx stays PSD and
Quu >= 2(Ru + Rdu) > 0; a 1e-8 jitter guards the 2x2 inverses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dart_tpu.ops.lanes import (add_diag_vec, boxqp2_stacked, diag_embed,
                                gains2_stacked, mm, mT, mv, rk4_jac)
_G = 9.81   # positive, hard-coded like the reference (`rlmpc2.py:342`)


def _lmpc_body(N, n_iters, n_alphas, dt, roll_loops,
               praw, Q, Rfull, Qt, target, z0, V, u_lo, u_hi):
    Ru = Rfull[0:2]
    Rdu = Rfull[2:4]
    x0 = z0[0:8]
    up0 = z0[8:10]

    # ---- squash the positivity-constrained parameters once (|p| + 1e-6,
    # identical index set to `models.dynamics._SQUASHED`) ----
    def sq(i):
        return jnp.abs(praw[i]) + 1e-6

    m_x, m_y = sq(0), sq(1)
    c_x, c_y = sq(2), sq(3)
    k_x, k_y = sq(4), sq(5)
    f_s_x, f_c_x, b_x = praw[6], praw[7], praw[8]
    v_s_x, eps_x = sq(9), sq(10)
    f_s_y, f_c_y, b_y = praw[11], praw[12], praw[13]
    v_s_y, eps_y = sq(14), sq(15)
    i_x, i_y = sq(16), sq(17)
    r_x, r_y = sq(18), sq(19)
    c_rot_x, c_rot_y = sq(20), sq(21)
    f_s_rx, f_c_rx, b_rx = praw[22], praw[23], praw[24]
    v_s_rx, eps_rx = sq(25), sq(26)
    f_s_ry, f_c_ry, b_ry = praw[27], praw[28], praw[29]
    v_s_ry, eps_ry = sq(30), sq(31)
    h_com_x, h_com_y = sq(32), sq(33)
    ix = i_x + 1e-12
    iy = i_y + 1e-12

    def strib(v, f_s, f_c, b, v_s, eps):
        stc = f_c + (f_s - f_c) * jnp.exp(-jnp.abs(v) / (v_s + 1e-12))
        return jnp.tanh(v / eps) * stc + b * v

    def dstrib(v, f_s, f_c, b, v_s, eps):
        vs = v_s + 1e-12
        ex = jnp.exp(-jnp.abs(v) / vs)
        stc = f_c + (f_s - f_c) * ex
        t = jnp.tanh(v / eps)
        return (1.0 - t * t) / eps * stc + \
            t * (f_s - f_c) * ex * (-jnp.sign(v) / vs) + b

    def f8(x, v):
        """xdot (8, L) — lane transcription of `models.dynamics.lmpc_dynamics`."""
        px, vx, py, vy = x[0], x[1], x[2], x[3]
        th_x, om_x, th_y, om_y = x[4], x[5], x[6], x[7]
        a, b_u = v[0], v[1]
        g_x = m_x * _G * jnp.sin(a)
        g_y = m_y * _G * jnp.sin(b_u)
        ff_x = strib(vx, f_s_x, f_c_x, b_x, v_s_x, eps_x)
        ff_y = strib(vy, f_s_y, f_c_y, b_y, v_s_y, eps_y)
        v_slip_x = vx - r_x * om_y
        v_slip_y = vy + r_y * om_x
        f_roll_x = strib(v_slip_x, f_s_x, f_c_x, b_x, v_s_x, eps_x)
        f_roll_y = strib(v_slip_y, f_s_y, f_c_y, b_y, v_s_y, eps_y)
        t_noslip_x = strib(om_x, f_s_rx, f_c_rx, b_rx, v_s_rx, eps_rx)
        t_noslip_y = strib(om_y, f_s_ry, f_c_ry, b_ry, v_s_ry, eps_ry)
        tau_x = (-r_y * f_roll_y - t_noslip_x - c_rot_x * om_x
                 - m_y * _G * h_com_x * jnp.sin(th_x))
        tau_y = (-r_x * f_roll_x - t_noslip_y - c_rot_y * om_y
                 - m_x * _G * h_com_y * jnp.sin(th_y))
        qdd_x = (g_x - c_x * vx - k_x * px - ff_x - f_roll_x) / m_x
        qdd_y = (g_y - c_y * vy - k_y * py - ff_y - f_roll_y) / m_y
        return jnp.stack([vx, qdd_x, vy, qdd_y,
                          om_x, tau_x / ix, om_y, tau_y / iy])

    def rk4(x, v):
        k1 = f8(x, v)
        k2 = f8(x + 0.5 * dt * k1, v)
        k3 = f8(x + 0.5 * dt * k2, v)
        k4 = f8(x + dt * k3, v)
        return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def jac8(x, v):
        """Continuous-time (A (8,8,L), B (8,2,L)) — `models.dynamics.lmpc_jac`."""
        vx, vy = x[1], x[3]
        th_x, om_x, th_y, om_y = x[4], x[5], x[6], x[7]
        a, b_u = v[0], v[1]
        Dff_x = dstrib(vx, f_s_x, f_c_x, b_x, v_s_x, eps_x)
        Dff_y = dstrib(vy, f_s_y, f_c_y, b_y, v_s_y, eps_y)
        Dfr_x = dstrib(vx - r_x * om_y, f_s_x, f_c_x, b_x, v_s_x, eps_x)
        Dfr_y = dstrib(vy + r_y * om_x, f_s_y, f_c_y, b_y, v_s_y, eps_y)
        Dtn_x = dstrib(om_x, f_s_rx, f_c_rx, b_rx, v_s_rx, eps_rx)
        Dtn_y = dstrib(om_y, f_s_ry, f_c_ry, b_ry, v_s_ry, eps_ry)
        z = jnp.zeros_like(vx)
        o = jnp.ones_like(vx)
        r_vx = [-k_x / m_x, (-c_x - Dff_x - Dfr_x) / m_x, z, z,
                z, z, z, r_x * Dfr_x / m_x]
        r_vy = [z, z, -k_y / m_y, (-c_y - Dff_y - Dfr_y) / m_y,
                z, -r_y * Dfr_y / m_y, z, z]
        r_alx = [z, z, z, -r_y * Dfr_y / ix,
                 -m_y * _G * h_com_x * jnp.cos(th_x) / ix,
                 (-r_y * r_y * Dfr_y - Dtn_x - c_rot_x) / ix, z, z]
        r_aly = [z, -r_x * Dfr_x / iy, z, z, z, z,
                 -m_x * _G * h_com_y * jnp.cos(th_y) / iy,
                 (r_x * r_x * Dfr_x - Dtn_y - c_rot_y) / iy]

        def e(i):
            return [o if j == i else z for j in range(8)]

        A = jnp.stack([jnp.stack(r) for r in
                       (e(1), r_vx, e(3), r_vy, e(5), r_alx, e(7), r_aly)])
        ca = _G * jnp.cos(a)
        cb = _G * jnp.cos(b_u)
        B = jnp.stack([jnp.stack([z, z]), jnp.stack([ca, z]),
                       jnp.stack([z, z]), jnp.stack([z, cb]),
                       jnp.stack([z, z]), jnp.stack([z, z]),
                       jnp.stack([z, z]), jnp.stack([z, z])])
        return A, B

    def rk4_jac8(x, v):
        """Exact (Ad, Bd) of the RK4 step (`models.dynamics.rk4_jac`)."""
        return rk4_jac(f8, jac8, x, v, dt)

    def stage_cost(x, v, up):
        e = x - target
        du = v - up
        return (jnp.sum(Q * e * e, axis=0)
                + Ru[0] * v[0] * v[0] + Ru[1] * v[1] * v[1]
                + Rdu[0] * du[0] * du[0] + Rdu[1] * du[1] * du[1])

    def terminal_cost(x):
        e = x - target
        return jnp.sum(Qt * e * e, axis=0)

    def with_start(first, rest):
        return jnp.concatenate([first[None], rest])

    # Every stage loop is a `lax.scan` over the horizon, so the compiled
    # program holds one copy of each stage body whatever N is.
    def rollout_cost(V):
        def stage(c, v):
            x, up, cost = c
            cost = cost + stage_cost(x, v, up)
            x = rk4(x, v)
            return (x, v, cost), x

        (xN, _, cost), xs = jax.lax.scan(
            stage, (x0, up0, jnp.zeros_like(Ru[0])), V)
        return with_start(x0, xs), cost + terminal_cost(xN)   # (N+1, 8, L)

    X, cost = rollout_cost(V)
    alphas = [0.6 ** i for i in range(n_alphas)]

    def iteration(carry):
        X, V, cost, done, _ = carry
        # u_prev trajectory is implied by V: UP[0]=up0, UP[k]=V[k-1].
        UP = with_start(up0, V[:N - 1])

        # ---- backward: partitioned Riccati over z = [x(8), u_prev(2)] ----
        def backward_stage(c, inp):
            vx8, vu2, P, q, r = c
            x, v_k, up_k = inp
            Ad, Bd = rk4_jac8(x, v_k)
            e = x - target
            du = v_k - up_k
            lx8 = 2.0 * Q * e
            lx2 = -2.0 * Rdu * du
            lv = 2.0 * Ru * v_k + 2.0 * Rdu * du
            AdT = mT(Ad)
            BdT = mT(Bd)
            Qx8 = lx8 + mv(AdT, vx8)
            Qx2 = lx2
            Qu = lv + mv(BdT, vx8) + vu2
            Qxx11 = add_diag_vec(mm(mm(AdT, P), Ad), 2.0 * Q)
            T2 = mm(BdT, P) + mT(q)            # (2, 8, L)
            Qux1 = mm(T2, Ad)                   # (2, 8, L)
            z_l = jnp.zeros_like(Rdu[0])
            Qux2 = jnp.stack([jnp.stack([-2.0 * Rdu[0], z_l]),
                              jnp.stack([z_l, -2.0 * Rdu[1]])])
            Quu = mm(T2, Bd) + mm(BdT, q) + r
            Quu = 0.5 * (Quu + mT(Quu))
            Quu = add_diag_vec(Quu, 2.0 * (Ru + Rdu) + 1e-8)

            lo = u_lo - v_k
            hi = u_hi - v_k
            d, free = boxqp2_stacked(Quu, Qu, lo, hi)
            gn = jnp.maximum(jnp.abs(d[0]), jnp.abs(d[1]))

            cols = gains2_stacked(
                Quu, free,
                [(Qux1[0, j], Qux1[1, j]) for j in range(8)]
                + [(Qux2[0, j], Qux2[1, j]) for j in range(2)])
            k1cols, k2cols = cols[:8], cols[8:]
            K1 = jnp.stack([jnp.stack([c[0] for c in k1cols]),
                            jnp.stack([c[1] for c in k1cols])])  # (2, 8, L)
            K2 = jnp.stack([jnp.stack([c[0] for c in k2cols]),
                            jnp.stack([c[1] for c in k2cols])])  # (2, 2, L)

            w2 = mv(Quu, d) + Qu
            vx8 = Qx8 + mv(mT(K1), w2) + mv(mT(Qux1), d)
            vu2 = Qx2 + mv(mT(K2), w2) + mv(mT(Qux2), d)
            K1T_Quu = mm(mT(K1), Quu)          # (8, 2, L)
            M = mm(mT(K1), Qux1)               # (8, 8, L)
            P = Qxx11 + mm(K1T_Quu, K1) + M + mT(M)
            P = 0.5 * (P + mT(P))
            q = (mm(K1T_Quu, K2) + mm(mT(K1), Qux2)
                 + mm(mT(Qux1), K2))
            K2T_Quu = mm(mT(K2), Quu)
            M2 = mm(mT(K2), Qux2)
            r = mm(K2T_Quu, K2) + M2 + mT(M2)
            r = add_diag_vec(0.5 * (r + mT(r)), 2.0 * Rdu)
            return (vx8, vu2, P, q, r), (d, K1, K2, gn)

        zero = jnp.zeros_like(Qt[0])
        init = (2.0 * Qt * (X[N] - target),          # dV/dx
                jnp.zeros_like(up0),                  # dV/du_prev
                2.0 * diag_embed(Qt),                 # (8, 8, L)
                jnp.stack([jnp.stack([zero] * 2)] * 8),
                jnp.stack([jnp.stack([zero] * 2)] * 2))
        _, (Ds, K1s, K2s, gns) = jax.lax.scan(
            backward_stage, init, (X[:N], V, UP), reverse=True)

        # ---- forward line search with per-lane acceptance ----
        def forward(al):
            def stage(c, inp):
                x, up, cost = c
                v_ref, d, K1, K2, x_ref, up_ref = inp
                v = (v_ref + al * d + mv(K1, x - x_ref)
                     + mv(K2, up - up_ref))
                v = jnp.clip(v, u_lo, u_hi)
                cost = cost + stage_cost(x, v, up)
                x = rk4(x, v)
                return (x, v, cost), (x, v)

            (xN, _, cost), (xs, vs) = jax.lax.scan(
                stage, (x0, up0, jnp.zeros_like(Ru[0])),
                (V, Ds, K1s, K2s, X[:N], UP))
            return with_start(x0, xs), vs, cost + terminal_cost(xN)

        accepted = done
        X_best, V_best, c_best = X, V, cost
        for al in alphas:
            X_new, V_new, c_new = forward(al)
            newly = (~accepted) & (c_new < cost - 1e-12)
            m3 = newly[None, None, :]
            X_best = jnp.where(m3, X_new, X_best)
            V_best = jnp.where(m3, V_new, V_best)
            c_best = jnp.where(newly, c_new, c_best)
            accepted = accepted | newly

        rel = (cost - c_best) / (jnp.abs(cost) + 1.0)
        done_n = done | (accepted & (rel < 1e-9)) | (~accepted)
        return (X_best, V_best, c_best, done_n, jnp.max(gns, axis=0))

    done = jnp.zeros_like(cost, dtype=jnp.bool_)
    carry = (X, V, cost, done, jnp.zeros_like(cost))
    # Small budgets unroll; robust budgets roll via fori_loop — one
    # compiled iteration body instead of n_iters copies.
    roll = (n_iters > 3) if roll_loops is None else roll_loops
    if not roll:
        for _ in range(n_iters):
            carry = iteration(carry)
    else:
        carry = jax.lax.fori_loop(0, n_iters, lambda _, c: iteration(c),
                                  carry)
    _, V, cost, _, gnorm = carry
    # gnorm: max |feedforward| of the LAST iteration (the generic solver's
    # grad_norm).
    return V, cost, gnorm


@functools.partial(jax.jit, static_argnames=("n_iters", "n_alphas", "dt",
                                             "u_bound", "roll_loops"))
def lmpc_solve(pvec, Q, R, Qt, target, z0, V0, dt: float,
               u_bound: float = 0.4, n_iters: int = 2, n_alphas: int = 3,
               roll_loops=None):
    """Batch-last layout: pvec (34,B), Q/Qt/target (8,B), R (4,B),
    z0 (10,B), V0 (N,2,B). Returns (V, cost, gnorm)."""
    dtype = V0.dtype
    B = V0.shape[-1]
    lo = jnp.full((2, B), -u_bound, dtype)
    hi = jnp.full((2, B), u_bound, dtype)
    return _lmpc_body(V0.shape[0], n_iters, n_alphas, dt, roll_loops,
                      pvec.astype(dtype), Q.astype(dtype), R.astype(dtype),
                      Qt.astype(dtype), target.astype(dtype),
                      z0.astype(dtype), jnp.clip(V0, -u_bound, u_bound),
                      lo, hi)
