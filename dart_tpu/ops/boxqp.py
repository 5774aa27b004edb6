"""Box-constrained QP kernels for the control-limited DDP backward pass.

Replaces the role of IPOPT on the tray OCP's control bounds
(`PMPC/src/controller/mpc_3d.py:74-79` et al.): instead of interior-point
bound handling, the trajectory optimiser solves, at every Riccati stage,

    min_d  0.5 d' Quu d + Qu' d    s.t.  lo <= d <= hi

For the tray problem nu == 2, so the QP is solved *exactly* by enumerating
all 3^2 = 9 active sets — fully branch-free, vectorises across the horizon
scan and the scenario batch, and maps to closed-form elementwise 2x2 algebra.
A projected-Newton fallback (`boxqp_pn`) covers general nu.

All functions are jit/vmap-safe and dtype-polymorphic.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_BIG = 1e30


def _inv2(a: jnp.ndarray, reg: float = 0.0) -> jnp.ndarray:
    """Closed-form inverse of a symmetric 2x2 (with tiny Tikhonov guard)."""
    a00, a01, a11 = a[0, 0] + reg, a[0, 1], a[1, 1] + reg
    det = a00 * a11 - a01 * a01
    det = jnp.where(jnp.abs(det) < 1e-30, jnp.sign(det) * 1e-30 + 1e-30, det)
    return jnp.array([[a11, -a01], [-a01, a00]]) / det


def boxqp2(Quu: jnp.ndarray, Qu: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray):
    """Exact 2-d box QP via active-set enumeration.

    Args:
      Quu: (2, 2) symmetric positive definite Hessian.
      Qu:  (2,) gradient at d = 0.
      lo, hi: (2,) bounds (lo <= 0 <= hi not required).

    Returns:
      d: (2,) optimal step, free_mask: (2,) float 1.0 where dimension is free.

    The optimal active set satisfies: free dims stationary, dims at lower
    bound have gradient >= 0, dims at upper bound have gradient <= 0. All 9
    candidate sets are evaluated and the feasible one with least objective is
    selected (branch-free `argmin` over a static stack).
    """
    dtype = Qu.dtype
    ds, feas = [], []
    free_masks = []
    for s0 in range(3):  # 0 free, 1 lo, 2 hi
        for s1 in range(3):
            status = (s0, s1)
            fixed = jnp.array(
                [lo[0] if s0 == 1 else (hi[0] if s0 == 2 else 0.0),
                 lo[1] if s1 == 1 else (hi[1] if s1 == 2 else 0.0)], dtype=dtype)
            free = jnp.array([s0 == 0, s1 == 0], dtype=dtype)
            if s0 == 0 and s1 == 0:
                d = -_inv2(Quu) @ Qu
            elif s0 == 0:  # dim0 free, dim1 fixed
                d1 = fixed[1]
                d0 = -(Qu[0] + Quu[0, 1] * d1) / jnp.maximum(Quu[0, 0], 1e-30)
                d = jnp.stack([d0, d1])
            elif s1 == 0:  # dim1 free, dim0 fixed
                d0 = fixed[0]
                d1 = -(Qu[1] + Quu[0, 1] * d0) / jnp.maximum(Quu[1, 1], 1e-30)
                d = jnp.stack([d0, d1])
            else:
                d = fixed
            g = Quu @ d + Qu
            ok = jnp.array(True)
            for i, s in enumerate(status):
                if s == 0:
                    ok &= (d[i] >= lo[i] - 1e-9) & (d[i] <= hi[i] + 1e-9)
                elif s == 1:
                    ok &= g[i] >= -1e-9
                else:
                    ok &= g[i] <= 1e-9
            obj = 0.5 * d @ Quu @ d + Qu @ d
            ds.append(jnp.clip(d, lo, hi))
            feas.append(jnp.where(ok, obj, _BIG))
            free_masks.append(free)
    ds = jnp.stack(ds)            # (9, 2)
    feas = jnp.stack(feas)        # (9,)
    free_masks = jnp.stack(free_masks)
    # Guard: if no candidate passed the optimality conditions (numerically
    # degenerate Quu), fall back to the clipped Newton step (candidate 0).
    best = jnp.argmin(feas)
    d = ds[best]
    free = free_masks[best]
    return d, free


@partial(jax.jit, static_argnames=("iters",))
def boxqp_pn(Quu: jnp.ndarray, Qu: jnp.ndarray, lo: jnp.ndarray,
             hi: jnp.ndarray, iters: int = 12):
    """Projected-Newton box QP for general nu (Bertsekas 1982 / Tassa 2014).

    Used when nu > 2 (not on the tray path). Returns (d, free_mask).
    """
    n = Qu.shape[0]
    d = jnp.clip(jnp.zeros_like(Qu), lo, hi)

    def body(_, d):
        g = Quu @ d + Qu
        at_lo = (d <= lo + 1e-9) & (g > 0)
        at_hi = (d >= hi - 1e-9) & (g < 0)
        clamped = at_lo | at_hi
        free = ~clamped
        fm = free.astype(Qu.dtype)
        # Newton step on the free subspace: mask rows/cols of Quu.
        H = Quu * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm)
        gf = g * fm
        dn = jnp.linalg.solve(H, gf)
        step = -dn * fm
        # Backtracking: exact minimisation along [0,1] of the quadratic.
        num = -(g @ step)
        den = step @ Quu @ step
        alpha = jnp.where(den > 1e-30, jnp.clip(num / den, 0.0, 1.0), 1.0)
        return jnp.clip(d + alpha * step, lo, hi)

    d = jax.lax.fori_loop(0, iters, body, d)
    g = Quu @ d + Qu
    at_lo = (d <= lo + 1e-9) & (g > 0)
    at_hi = (d >= hi - 1e-9) & (g < 0)
    free = (~(at_lo | at_hi)).astype(Qu.dtype)
    return d, free


def boxqp(Quu: jnp.ndarray, Qu: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray):
    """Dispatch: exact enumeration for nu==2, projected Newton otherwise."""
    if Qu.shape[-1] == 2:
        return boxqp2(Quu, Qu, lo, hi)
    return boxqp_pn(Quu, Qu, lo, hi)
