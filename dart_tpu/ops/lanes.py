"""Lane algebra: small-matrix operations with the scenario batch on the last
axis.

The whole-solve bodies (`ops.pallas.pmpc_solve`, `ops.rmpc_solve`,
`ops.lmpc_solve`) hold every matrix entry as a vector over scenarios, so a
6x6 product is a short chain of elementwise FMAs and the batch never leaves
the trailing axis. Stacked operands are shaped (n, k, L); the scalar-argument
forms (`boxqp2`, `gains2`) take one (L,) vector per entry and are shared with
the list-form PMPC body, which cannot stack (the Triton lowering refuses
arrays whose size is not a power of two).

Pallas kernels may not capture constant arrays, so nothing here builds an
identity or zero matrix from a constant: diagonals are added entrywise.
"""

from __future__ import annotations

import jax.numpy as jnp

_BIG = 1e30


def mm(a, b):
    """(n,k,L) @ (k,m,L) -> (n,m,L), row-blocked: row i of the result is one
    chain of k FMAs on (m, L) tiles, ``C[i] = sum_t a[i,t] * b[t]``."""
    n, k1 = a.shape[0], a.shape[1]
    assert k1 == b.shape[0]
    rows = []
    for i in range(n):
        acc = a[i, 0][None] * b[0]
        for t in range(1, k1):
            acc = acc + a[i, t][None] * b[t]
        rows.append(acc)
    return jnp.stack(rows)


def mT(a):
    return jnp.swapaxes(a, 0, 1)


def mv(a, v):
    """(n,k,L) @ (k,L) -> (n,L)."""
    n, k = a.shape[0], a.shape[1]
    out = []
    for i in range(n):
        acc = a[i, 0] * v[0]
        for t in range(1, k):
            acc = acc + a[i, t] * v[t]
        out.append(acc)
    return jnp.stack(out)


def add_diag_vec(M, w):
    """(n,n,L) + diag(w) with w (n,L)."""
    n = M.shape[0]
    return jnp.stack([jnp.stack([M[i, j] + w[i] if i == j else M[i, j]
                                 for j in range(n)]) for i in range(n)])


def diag_embed(w):
    """(n, L) -> (n, n, L) diagonal embedding."""
    n = w.shape[0]
    z = jnp.zeros_like(w[0])
    return jnp.stack([jnp.stack([w[i] if i == j else z for j in range(n)])
                      for i in range(n)])


def _scale_add_eye(M, s):
    """I + s*M for (n,n,L)."""
    n = M.shape[0]
    return jnp.stack([jnp.stack([s * M[i, j] + 1.0 if i == j else s * M[i, j]
                                 for j in range(n)]) for i in range(n)])


def rk4_jac(f, jac, x, v, dt):
    """Exact (Ad, Bd) of an RK4 step in (n,*,L) lane algebra.

    Mirrors `models.dynamics.rk4_jac` (exact chain rule through the four
    stages): f(x,v) -> (n,L), jac(x,v) -> (A (n,n,L), B (n,m,L)).
    """
    k1 = f(x, v)
    x2 = x + 0.5 * dt * k1
    k2 = f(x2, v)
    x3 = x + 0.5 * dt * k2
    x4 = x + dt * f(x3, v)
    A1, B1 = jac(x, v)
    A2, B2 = jac(x2, v)
    A3, B3 = jac(x3, v)
    A4, B4 = jac(x4, v)
    dk2x = mm(A2, _scale_add_eye(A1, 0.5 * dt))
    dk2u = mm(A2, 0.5 * dt * B1) + B2
    dk3x = mm(A3, _scale_add_eye(dk2x, 0.5 * dt))
    dk3u = mm(A3, 0.5 * dt * dk2u) + B3
    dk4x = mm(A4, _scale_add_eye(dk3x, dt))
    dk4u = mm(A4, dt * dk3u) + B4
    Ad = _scale_add_eye(A1 + 2.0 * dk2x + 2.0 * dk3x + dk4x, dt / 6.0)
    Bd = dt / 6.0 * (B1 + 2.0 * dk2u + 2.0 * dk3u + dk4u)
    return Ad, Bd


def boxqp2(q00, q01, q11, g0, g1, lo0, hi0, lo1, hi1):
    """Exact lane-wise 2x2 box QP, min 0.5 d'Qd + g'd s.t. lo <= d <= hi
    (mirrors `dart_tpu.ops.boxqp.boxqp2`): enumerate the 9 active sets and
    keep the feasible candidate of least objective.

    Returns (d0, d1, f0, f1) with f the free-set indicator (1.0 free).
    """
    det = q00 * q11 - q01 * q01
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    zero = jnp.zeros_like(q00)
    best = None
    for s0 in range(3):
        for s1 in range(3):
            c0 = (zero, lo0, hi0)[s0]
            c1 = (zero, lo1, hi1)[s1]
            if s0 == 0 and s1 == 0:
                d0 = -(q11 * g0 - q01 * g1) / det
                d1 = -(-q01 * g0 + q00 * g1) / det
            elif s0 == 0:
                d1 = c1
                d0 = -(g0 + q01 * d1) / jnp.maximum(q00, 1e-30)
            elif s1 == 0:
                d0 = c0
                d1 = -(g1 + q01 * d0) / jnp.maximum(q11, 1e-30)
            else:
                d0, d1 = c0, c1
            r0 = q00 * d0 + q01 * d1 + g0
            r1 = q01 * d0 + q11 * d1 + g1
            ok = None
            for s, d, r, lo_i, hi_i in ((s0, d0, r0, lo0, hi0),
                                        (s1, d1, r1, lo1, hi1)):
                if s == 0:
                    c = (d >= lo_i - 1e-9) & (d <= hi_i + 1e-9)
                elif s == 1:
                    c = r >= -1e-9
                else:
                    c = r <= 1e-9
                ok = c if ok is None else ok & c
            obj = 0.5 * (d0 * r0 + d1 * r1) + 0.5 * (g0 * d0 + g1 * d1)
            cand = (jnp.where(ok, obj, _BIG), jnp.clip(d0, lo0, hi0),
                    jnp.clip(d1, lo1, hi1),
                    1.0 if s0 == 0 else 0.0, 1.0 if s1 == 0 else 0.0)
            if best is None:
                best = (cand[0], cand[1], cand[2], cand[3] + zero,
                        cand[4] + zero)
            else:
                better = cand[0] < best[0]
                best = tuple(jnp.where(better, c, b)
                             for c, b in zip(cand, best))
    _, d0, d1, f0, f1 = best
    return d0, d1, f0, f1


def gains2(q00, q01, q11, f0, f1, cols):
    """Feedback gains on the free set: solve H K = -(Qux * free) columnwise,
    H = free Quu free + diag(1 - free). `cols` is a sequence of (b0, b1)
    lane pairs, one per state column; returns a list of (k0, k1) pairs."""
    h00 = q00 * f0 * f0 + (1.0 - f0)
    h01 = q01 * f0 * f1
    h11 = q11 * f1 * f1 + (1.0 - f1)
    deth = h00 * h11 - h01 * h01
    deth = jnp.where(jnp.abs(deth) < 1e-30, 1e-30, deth)
    ideth = 1.0 / deth
    out = []
    for b0, b1 in cols:
        b0 = b0 * f0
        b1 = b1 * f1
        out.append((-(h11 * b0 - h01 * b1) * ideth,
                    -(-h01 * b0 + h00 * b1) * ideth))
    return out


def boxqp2_stacked(Quu, Qu, lo, hi):
    """`boxqp2` on stacked operands: Quu (2,2,L), Qu/lo/hi (2,L).
    Returns d (2,L), free (2,L)."""
    d0, d1, f0, f1 = boxqp2(Quu[0, 0], Quu[0, 1], Quu[1, 1], Qu[0], Qu[1],
                            lo[0], hi[0], lo[1], hi[1])
    return jnp.stack([d0, d1]), jnp.stack([f0, f1])


def gains2_stacked(Quu, free, cols):
    """`gains2` with stacked Quu (2,2,L) and free (2,L)."""
    return gains2(Quu[0, 0], Quu[0, 1], Quu[1, 1], free[0], free[1], cols)
