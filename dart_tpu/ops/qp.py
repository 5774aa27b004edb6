"""Dense ADMM QP solver (OSQP-style) for two-sided linear constraints.

    min_x  0.5 x' P x + q' x    s.t.   l <= A x <= u

Replaces IPOPT on the per-arm impedance QP (7 vars, 21 two-sided
constraints, `PMPC/src/controller/arm.py:338-424`) — but instead of one
process per arm per solve, thousands of these QPs batch under `vmap` (two
arms x scenario batch) as dense 7x7 factorisations.

Fixed-iteration ADMM with over-relaxation; warm-startable with (x, y, z)
from the previous control step (the reference warm-starts IPOPT with primal
and dual iterates the same way, `arm.py:297-314, 434-437`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class QPSolution(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray          # dual for the Ax rows
    z: jnp.ndarray          # auxiliary (projected Ax)
    pri_res: jnp.ndarray    # final primal residual ||Ax - z||_inf
    dua_res: jnp.ndarray    # final dual residual


@partial(jax.jit, static_argnames=("iters",))
def solve_qp_admm(P: jnp.ndarray, q: jnp.ndarray, A: jnp.ndarray,
                  l: jnp.ndarray, u: jnp.ndarray,
                  x0: jnp.ndarray | None = None,
                  y0: jnp.ndarray | None = None,
                  rho: float = 0.4, sigma: float = 1e-6, alpha: float = 1.6,
                  iters: int = 100) -> QPSolution:
    """OSQP ADMM splitting with fixed iteration count (jit/vmap-safe)."""
    n = q.shape[0]
    m = l.shape[0]
    dtype = q.dtype
    x = jnp.zeros(n, dtype) if x0 is None else x0
    y = jnp.zeros(m, dtype) if y0 is None else y0
    z = jnp.clip(A @ x, l, u)

    K = P + sigma * jnp.eye(n, dtype=dtype) + rho * (A.T @ A)
    # One Cholesky factorisation per solve; small dense systems.
    L = jnp.linalg.cholesky(K)

    def body(_, carry):
        x, z, y = carry
        rhs = sigma * x - q + A.T @ (rho * z - y)
        xt = jax.scipy.linalg.cho_solve((L, True), rhs)
        zt = A @ xt
        # OSQP over-relaxation: mix the *auxiliary* iterate with z, not Ax.
        x_new = alpha * xt + (1 - alpha) * x
        z_relaxed = alpha * zt + (1 - alpha) * z
        z_new = jnp.clip(z_relaxed + y / rho, l, u)
        y_new = y + rho * (z_relaxed - z_new)
        return (x_new, z_new, y_new)

    x, z, y = jax.lax.fori_loop(0, iters, body, (x, z, y))
    Ax = A @ x
    pri = jnp.max(jnp.abs(Ax - z))
    dua = jnp.max(jnp.abs(P @ x + q + A.T @ y))
    return QPSolution(x=x, y=y, z=z, pri_res=pri, dua_res=dua)
