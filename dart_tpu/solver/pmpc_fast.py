"""Structure-exploiting PMPC solver: the speed-of-light path.

The PMPC continuous dynamics (`models.dynamics.pmpc_dynamics`) are *affine
in the state*: xdot = M(mu) x + c(u) with

  M = [[0,1,0,0,0,0], [0,-mu,0,0,0,0], [0,0,0,1,0,0], [0,0,0,-mu,0,0],
       [0,0,0,0,0,0], [0,0,0,0,0,-1/Ts]]
  c(u) = [0, g sin u0, 0, g sin u1, w, w/Ts],  w = -g (u0^2 + u1^2).

RK4 of an affine system is exactly affine:  x+ = Ad x + Sd c(u)  with
constant matrices Ad, Sd (per-lane functions of mu only), so

- the dynamics Jacobians are CLOSED FORM: A_k = Ad (constant over horizon
  and iterations), B_k = Sd @ dc/du(u_k) (4 nonzero rows of sin/cos terms);
- the cost quadratics are constant diagonals;
- the generic solver's entire autodiff linearisation stage (vmapped
  jacfwd + hessian, the largest remaining cost after the fused backward)
  disappears.

`solve_batch_fast` runs the same box-DDP iteration as `ilqr.solve_batch`
(same backward pass, same backtracking acceptance) and produces the same
solutions — validated against the generic path in `tests/test_pmpc_fast.py`.
`solve_batch_kernel` runs the fixed-budget whole solve of
`ops.pallas.pmpc_solve` on the same closed-form operators.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dart_tpu.models import dynamics as dyn
from dart_tpu.solver import ilqr
from dart_tpu.solver.ocp import PMPCAux, make_pmpc_ocp


def _affine_discretization(mu, g, dt):
    """Per-scenario (Ad, Sd): exact RK4 of the affine system.

    Computed by propagating basis vectors through the state-linear part and
    accumulating the RK4 input operator Sd = dt/6 (I + 2P1 + 2P2 + P3') --
    equivalently via jacfwd of one RK4 step, which is exact here because the
    system is affine. mu may be batched (...,).
    """
    dtype = jnp.result_type(mu)
    z = jnp.zeros_like(mu)
    o = jnp.ones_like(mu)
    inv_ts = o / dt
    M = jnp.stack([
        jnp.stack([z, o, z, z, z, z], -1),
        jnp.stack([z, -mu, z, z, z, z], -1),
        jnp.stack([z, z, z, o, z, z], -1),
        jnp.stack([z, z, z, -mu, z, z], -1),
        jnp.stack([z, z, z, z, z, z], -1),
        jnp.stack([z, z, z, z, z, -inv_ts], -1),
    ], -2)                                           # (..., 6, 6)
    eye = jnp.eye(6, dtype=dtype)
    M2 = M @ M
    M3 = M2 @ M
    M4 = M3 @ M
    # x+ = x + dt/6 (k1+2k2+2k3+k4) with ki affine recursions:
    # Ad = I + dt M + dt^2/2 M^2 + dt^3/6 M^3 + dt^4/24 M^4  (exact RK4)
    Ad = (eye + dt * M + dt**2 / 2 * M2 + dt**3 / 6 * M3 + dt**4 / 24 * M4)
    # Sd = dt I + dt^2/2 M + dt^3/6 M^2 + dt^4/24 M^3
    Sd = (dt * eye + dt**2 / 2 * M + dt**3 / 6 * M2 + dt**4 / 24 * M3)
    return Ad, Sd


# The XLA solver's contractions run at full float32 precision: on a GPU the
# default may be TF32, which moved its solutions by ~1e-2 relative on an
# H100 (PERF.md). The operators above need no such care (bitwise equal).
_HIGHEST = jax.lax.Precision.HIGHEST


def _bmv(M, x):
    """Batched matrix-vector product (B,i,j) x (B,j) -> (B,i)."""
    return jnp.einsum("bij,bj->bi", M, x, precision=_HIGHEST)


def _c_of_u(u, g, dt):
    """Input drive c(u) (..., 6)."""
    s0, s1 = jnp.sin(u[..., 0]), jnp.sin(u[..., 1])
    w = -g * (u[..., 0] ** 2 + u[..., 1] ** 2)
    z = jnp.zeros_like(s0)
    return jnp.stack([z, g * s0, z, g * s1, w, w / dt], -1)


def _dcdu(u, g, dt):
    """dc/du (..., 6, 2), closed form."""
    c0, c1 = jnp.cos(u[..., 0]), jnp.cos(u[..., 1])
    z = jnp.zeros_like(c0)
    du0 = jnp.stack([z, g * c0, z, z, -2 * g * u[..., 0],
                     -2 * g * u[..., 0] / dt], -1)
    du1 = jnp.stack([z, z, z, g * c1, -2 * g * u[..., 1],
                     -2 * g * u[..., 1] / dt], -1)
    return jnp.stack([du0, du1], -1)


@functools.partial(jax.jit, static_argnames=("dt", "u_bound", "n_iters",
                                             "n_alphas", "g", "route"))
def solve_batch_kernel(mu: jnp.ndarray, aux: PMPCAux, z0: jnp.ndarray,
                       V_init: jnp.ndarray, *, route: str, dt: float = 0.002,
                       u_bound: float = 0.6, n_iters: int = 2,
                       n_alphas: int = 3, g: float = dyn.GRAVITY_Z):
    """Fixed-budget whole solve (batch-first API) through `route`
    (`ops.route`): the Triton kernel, or the same body under XLA or the
    Pallas interpreter. Any B. Returns (V (B,N,2), cost (B,), gnorm (B,) —
    max |feedforward| of the last iteration, the convergence diagnostic).
    """
    from dart_tpu.ops.pallas.pmpc_solve import pmpc_solve

    dtype = V_init.dtype
    gq = jnp.asarray(g, dtype)
    Ad, Sd = _affine_discretization(mu.astype(dtype), gq, dt)
    wdiag = (aux.Qp[:, None] * jnp.asarray([1, 0, 1, 0, 0, 0], dtype) +
             aux.Qv[:, None] * jnp.asarray([0, 1, 0, 1, 0, 0], dtype))
    tl = lambda x: jnp.moveaxis(x, 0, -1)
    V, cost, gnorm = pmpc_solve(
        tl(Ad), tl(Sd), tl(wdiag), aux.R.astype(dtype), tl(aux.target),
        tl(z0), tl(V_init), dt=dt, u_bound=u_bound, g=float(g),
        n_iters=n_iters, n_alphas=n_alphas, route=route)
    return jnp.moveaxis(V, -1, 0), cost, gnorm


@functools.partial(jax.jit, static_argnames=("dt", "u_bound", "max_iters",
                                             "n_alphas"))
def solve_batch_fast(mu: jnp.ndarray, aux: PMPCAux, z0: jnp.ndarray,
                     V_init: jnp.ndarray, dt: float = 0.002,
                     u_bound: float = 0.6, g: float = dyn.GRAVITY_Z,
                     max_iters: int = 4, n_alphas: int = 8,
                     tol_cost: float = 1e-9):
    """Batched PMPC solve with closed-form linearisation.

    Args: mu (B,), aux leaves (B, ...) per PMPCAux, z0 (B, 6),
    V_init (B, N, 2). Returns (V (B,N,2), Z (B,N+1,6), cost (B,)).
    """
    B, N, nu = V_init.shape
    dtype = V_init.dtype
    gq = jnp.asarray(g, dtype)
    Ad, Sd = _affine_discretization(mu.astype(dtype), gq, dt)  # (B,6,6) x2
    u_lo = jnp.full((nu,), -u_bound, dtype)
    u_hi = jnp.full((nu,), u_bound, dtype)
    V = jnp.clip(V_init, u_lo, u_hi)

    # Constant cost quadratics (per lane): state weights on channels 0..3.
    sel_p = jnp.asarray([1.0, 0, 0, 0, 0, 0], dtype), \
        jnp.asarray([0, 0, 1.0, 0, 0, 0], dtype)
    wdiag = (aux.Qp[:, None] * (jnp.asarray([1, 0, 0, 0, 0, 0], dtype) +
                                jnp.asarray([0, 0, 1, 0, 0, 0], dtype))
             + aux.Qv[:, None] * (jnp.asarray([0, 1, 0, 0, 0, 0], dtype) +
                                  jnp.asarray([0, 0, 0, 1, 0, 0], dtype)))
    lxx = 2.0 * jax.vmap(jnp.diag)(wdiag)            # (B, 6, 6)
    luu = 2.0 * aux.R[:, None, None] * jnp.eye(2, dtype=dtype)[None]
    gxx = lxx                                        # terminal same weights

    def rollout(V):
        def f(x, v):
            xn = _bmv(Ad, x) + _bmv(Sd, _c_of_u(v, gq, dt))
            return xn, xn

        _, Zs = jax.lax.scan(f, z0, jnp.swapaxes(V, 0, 1))
        return jnp.concatenate([z0[:, None], jnp.swapaxes(Zs, 0, 1)], axis=1)

    def total_cost(Z, V):
        e = Z - aux.target[:, None, :]
        state_c = jnp.sum(wdiag[:, None, :] * e * e, axis=(1, 2))
        ctrl_c = aux.R[:, None] * jnp.sum(V * V, axis=-1)
        return state_c + jnp.sum(ctrl_c, axis=1)

    def linearize(Z, V):
        e = Z[:, :-1] - aux.target[:, None, :]
        lx = 2.0 * wdiag[:, None, :] * e                      # (B,N,6)
        lu = 2.0 * aux.R[:, None, None] * V                   # (B,N,2)
        Bmat = jnp.einsum("bij,bnjm->bnim", Sd, _dcdu(V, gq, dt),
                          precision=_HIGHEST)
        A = jnp.broadcast_to(Ad[:, None], (B, N, 6, 6))
        lxx_b = jnp.broadcast_to(lxx[:, None], (B, N, 6, 6))
        luu_b = jnp.broadcast_to(luu[:, None], (B, N, 2, 2))
        lux_b = jnp.zeros((B, N, 2, 6), dtype)
        eT = Z[:, -1] - aux.target
        gx = 2.0 * wdiag * eT
        return A, Bmat, lx, lu, lxx_b, lux_b, luu_b, gx, gxx

    def backward(derivs, V, reg):
        D, K, _, _ = jax.vmap(lambda d, v, r: ilqr._backward(
            d, v, u_lo, u_hi, r))(derivs, V, reg)
        return D, K

    def forward(Z, V, D, K, al):
        def f(x, inp):
            z_ref, v_ref, d, Kk = inp
            v = jnp.clip(v_ref + al[:, None] * d + _bmv(Kk, x - z_ref),
                         u_lo, u_hi)
            xn = _bmv(Ad, x) + _bmv(Sd, _c_of_u(v, gq, dt))
            return xn, (xn, v)

        swap = lambda a: jnp.swapaxes(a, 0, 1)
        _, (Zs, Vn) = jax.lax.scan(
            f, z0, (swap(Z[:, :-1]), swap(V), swap(D), swap(K)))
        Zn = jnp.concatenate([z0[:, None], swap(Zs)], axis=1)
        Vn = swap(Vn)
        return Zn, Vn, total_cost(Zn, Vn)

    alphas = jnp.power(0.6, jnp.arange(n_alphas)).astype(dtype)
    Z0 = rollout(V)
    cost0 = total_cost(Z0, V)

    def cond(c):
        _, _, _, it, done, _ = c
        return (it < max_iters) & (~jnp.all(done))

    def body(c):
        Z, V, cost, it, done, reg = c
        derivs = linearize(Z, V)
        D, K = backward(derivs, V, reg)

        def ls_cond(s):
            i, acc, _, _, _ = s
            return (i < n_alphas) & (~jnp.all(acc))

        def ls_body(s):
            i, acc, Zb, Vb, cb = s
            al = jnp.full((B,), alphas[i], dtype)
            Zc, Vc, cc = forward(Z, V, D, K, al)
            newly = (~acc) & (cc < cost - 1e-12)
            Zb = jnp.where(newly[:, None, None], Zc, Zb)
            Vb = jnp.where(newly[:, None, None], Vc, Vb)
            cb = jnp.where(newly, cc, cb)
            return (i + 1, acc | newly, Zb, Vb, cb)

        _, improved, Z_b, V_b, cost_new = jax.lax.while_loop(
            ls_cond, ls_body, (jnp.zeros((), jnp.int32), done, Z, V, cost))
        improved = improved & (~done)
        Z_n = jnp.where(improved[:, None, None], Z_b, Z)
        V_n = jnp.where(improved[:, None, None], V_b, V)
        reg_n = jnp.where(improved, jnp.maximum(reg * 0.25, 1e-9),
                          jnp.minimum(reg * 8.0, 1e9))
        cost_keep = jnp.where(improved, cost_new, cost)
        rel = (cost - cost_keep) / (jnp.abs(cost) + 1.0)
        done_n = done | (improved & (rel < tol_cost)) | \
            ((~improved) & (reg >= 1e9))
        return (Z_n, V_n, cost_keep, it + 1, done_n, reg_n)

    init = (Z0, V, cost0, jnp.zeros((), jnp.int32), jnp.zeros((B,), bool),
            jnp.full((B,), 1e-6, dtype))
    Z, V, cost, it, done, reg = jax.lax.while_loop(cond, body, init)
    return V, Z, cost
