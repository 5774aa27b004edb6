"""The complete PMPC box-DDP solve as one scalar program per scenario.

Because the PMPC dynamics are affine in state (x+ = Ad x + Sd c(u), see
`solver.pmpc_fast`), every stage of the box-DDP iteration is closed-form
scalar algebra: rollout, linearisation, Riccati backward with exact 2x2 box
QPs, forward line search with per-lane acceptance, several iterations. No
data is shared between scenarios, so the solve maps onto one GPU thread per
scenario.

The body `_pmpc_body` is written in LIST FORM: every per-scenario scalar is
its own vector over scenarios, held in Python lists (no (6, L) or
(N+1, 6, L) stacks in registers), and the per-stage trajectory, gains and
feedforwards live in storage refs read and written one row at a time, so
the stage loops roll. The same body therefore runs three ways:

- as a Pallas kernel through Triton (`route="triton"`), one program per
  block of `BLOCK` scenarios, loading and storing row by row — the Triton
  lowering refuses arrays whose size is not a power of two and cannot index
  rows of an in-register tensor, so lists of (block,) vectors are the only
  form it accepts;
- as plain `jnp` under XLA on (B,) arrays, with `jax.new_ref` arrays as
  the storage (`route="xla"`);
- as the Triton kernel in Pallas interpret mode on the CPU
  (`route="interpret"`, tests only).

STRUCTURE SPECIALISATION: `_affine_discretization` produces Ad/Sd as
polynomials of the 3-nonzero companion matrix M, so both are exactly
block-diagonal with per-axis [[1, a], [0, b]] blocks plus the decoupled vz
row. Only the 7 free entries enter the body, every Ad/Sd product is
specialised to that sparsity, and the symmetric Vxx update is built from its
21 unique entries. `structure_residual` guards the assumption: a lane whose
operators break it comes back with +inf certificates.

The iteration count and line-search schedule are static; converged lanes
are frozen by masks (compute proceeds, results are held).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from dart_tpu.ops.lanes import boxqp2, gains2
from dart_tpu.ops.route import ROUTES

# Scenarios per Triton program: one scenario per thread, BLOCK/32 warps.
# 64 measured fastest of {32, 64, 128} at B=4096 on an H100 (PERF.md).
BLOCK = 64


def _pmpc_body(N, n_iters, n_alphas, g, dt, u_bound, ad, sd, wdiag, rw,
               target, z0, Z, V, D, K):
    """The whole solve. Inputs are lane vectors: ad 3 (Ad[0,1], Ad[1,1],
    Ad[5,5]), sd 4 (Sd[0,1], Sd[1,1], Sd[4,4], Sd[5,5]), wdiag, target,
    z0 6 each, rw one. Z (N+1,6,L), V (N,2,L), D (N,2,L), K (N,2,6,L) are
    per-stage storage refs, read and written one row at a time: V holds the
    warm start on entry and the solution on exit; Z, D, K are scratch.
    Returns (cost, gnorm), gnorm = max |feedforward| of the last iteration.

    The stage loops are `fori_loop`s over that storage, so the compiled
    program holds one copy of each stage body, whatever N and the budget.
    """
    a_, b_, g_ = ad
    sg0, sg1, s44, s55 = sd
    s5dt = s55 * (1.0 / dt)
    w2 = [2.0 * w for w in wdiag]
    lo, hi = -u_bound, u_bound
    zero = jnp.zeros_like(rw)
    fori = jax.lax.fori_loop

    def load(ref, k, n):
        return [ref[k, j, :] for j in range(n)]

    def store(ref, k, vals):
        for j, v in enumerate(vals):
            ref[k, j, :] = v

    def step_dyn(x, v):
        """x+ = Ad x + Sd c(v), specialised to the sparsity."""
        gs0 = g * jnp.sin(v[0])
        gs1 = g * jnp.sin(v[1])
        w = -g * (v[0] * v[0] + v[1] * v[1])
        return [x[0] + a_ * x[1] + gs0 * sg0,
                b_ * x[1] + gs0 * sg1,
                x[2] + a_ * x[3] + gs1 * sg0,
                b_ * x[3] + gs1 * sg1,
                x[4] + s44 * w,
                g_ * x[5] + s5dt * w]

    def state_cost(x):
        e = x[0] - target[0]
        c = wdiag[0] * e * e
        for j in range(1, 6):
            e = x[j] - target[j]
            c = c + wdiag[j] * e * e
        return c

    def stage_cost(x, v):
        return state_cost(x) + rw * (v[0] * v[0] + v[1] * v[1])

    def control(k, x, z_k, v_k, al):
        """v = clip(V[k] + al D[k] + K[k] (x - Z[k]))."""
        d = load(D, k, 2)
        dx = [x[j] - z_k[j] for j in range(6)]
        v = []
        for i in range(2):
            fb = K[k, i, 0, :] * dx[0]
            for j in range(1, 6):
                fb = fb + K[k, i, j, :] * dx[j]
            v.append(jnp.clip(v_k[i] + al * d[i] + fb, lo, hi))
        return v

    # ---- initial rollout of the warm start ----
    store(Z, 0, z0)

    def rollout_stage(k, c):
        x, cost = c
        v = load(V, k, 2)
        cost = cost + stage_cost(x, v)
        x = step_dyn(x, v)
        store(Z, k + 1, x)
        return x, cost

    x, cost = fori(0, N, rollout_stage, (list(z0), zero))
    cost = cost + state_cost(x)

    alphas = [0.6 ** i for i in range(n_alphas)]
    ut = [(i, j) for i in range(6) for j in range(i, 6)]   # Vxx storage

    def backward_stage(s, c):
        """Riccati stage k = N-1-s (reg-free: Quu is PD here)."""
        k = N - 1 - s
        Vx, vxx, gnorm = c
        Vxx = [[vxx[ut.index((min(i, j), max(i, j)))] for j in range(6)]
               for i in range(6)]
        v0, v1 = load(V, k, 2)
        zk = load(Z, k, 6)
        # B = Sd dc/du: col0 lives on rows (0,1,4,5), col1 on (2,3,4,5).
        gc0 = g * jnp.cos(v0)
        gc1 = g * jnp.cos(v1)
        m2g0 = -2.0 * g * v0
        m2g1 = -2.0 * g * v1
        p0, p1, p4, p5 = gc0 * sg0, gc0 * sg1, m2g0 * s44, m2g0 * s5dt
        q2, q3, q4, q5 = gc1 * sg0, gc1 * sg1, m2g1 * s44, m2g1 * s5dt
        lx = [w2[j] * (zk[j] - target[j]) for j in range(6)]
        # Qx = lx + Ad^T Vx (Ad^T has FMAs only on rows 1, 3, 5)
        Qx = [lx[0] + Vx[0], lx[1] + a_ * Vx[0] + b_ * Vx[1],
              lx[2] + Vx[2], lx[3] + a_ * Vx[2] + b_ * Vx[3],
              lx[4] + Vx[4], lx[5] + g_ * Vx[5]]
        Qu0 = 2.0 * rw * v0 + p0 * Vx[0] + p1 * Vx[1] + p4 * Vx[4] \
            + p5 * Vx[5]
        Qu1 = 2.0 * rw * v1 + q2 * Vx[2] + q3 * Vx[3] + q4 * Vx[4] \
            + q5 * Vx[5]
        # W = Vxx @ Ad: columns 0,2,4 are copies, 1,3,5 short FMAs.
        W = [[r[0], a_ * r[0] + b_ * r[1], r[2], a_ * r[2] + b_ * r[3],
              r[4], g_ * r[5]] for r in Vxx]
        # Qxx - 2 diag(w) = Ad^T W (rows 0,2,4 are copies of W rows).
        Qxx = [W[0], [a_ * W[0][c] + b_ * W[1][c] for c in range(6)],
               W[2], [a_ * W[2][c] + b_ * W[3][c] for c in range(6)],
               W[4], [g_ * W[5][c] for c in range(6)]]
        # Qux = B^T W: 4-term dots against the sparse B columns.
        Qux0 = [p0 * W[0][j] + p1 * W[1][j] + p4 * W[4][j] + p5 * W[5][j]
                for j in range(6)]
        Qux1 = [q2 * W[2][j] + q3 * W[3][j] + q4 * W[4][j] + q5 * W[5][j]
                for j in range(6)]
        # Quu = B^T Vxx B through t0 = Vxx b0, t1 = Vxx b1.
        t0 = [Vxx[j][0] * p0 + Vxx[j][1] * p1 + Vxx[j][4] * p4
              + Vxx[j][5] * p5 for j in range(6)]
        t1 = [Vxx[j][2] * q2 + Vxx[j][3] * q3 + Vxx[j][4] * q4
              + Vxx[j][5] * q5 for j in (2, 3, 4, 5)]
        rdiag = 2.0 * rw + 1e-8
        q00 = p0 * t0[0] + p1 * t0[1] + p4 * t0[4] + p5 * t0[5] + rdiag
        q01 = q2 * t0[2] + q3 * t0[3] + q4 * t0[4] + q5 * t0[5]
        q11 = q2 * t1[0] + q3 * t1[1] + q4 * t1[2] + q5 * t1[3] + rdiag
        d0, d1, f0, f1 = boxqp2(q00, q01, q11, Qu0, Qu1,
                                lo - v0, hi - v0, lo - v1, hi - v1)
        gnorm = jnp.maximum(gnorm, jnp.maximum(jnp.abs(d0), jnp.abs(d1)))
        kk = gains2(q00, q01, q11, f0, f1, list(zip(Qux0, Qux1)))
        K0 = [c[0] for c in kk]
        K1 = [c[1] for c in kk]
        # Vx = Qx + K^T (Quu d + Qu) + Qux^T d
        r0 = q00 * d0 + q01 * d1 + Qu0
        r1 = q01 * d0 + q11 * d1 + Qu1
        Vx = [Qx[j] + K0[j] * r0 + K1[j] * r1 + Qux0[j] * d0
              + Qux1[j] * d1 for j in range(6)]
        # Vxx = Qxx + K^T Quu K + K^T Qux + (K^T Qux)^T, symmetric by
        # construction from its 21 unique entries.
        kq = [(K0[j] * q00 + K1[j] * q01, K0[j] * q01 + K1[j] * q11)
              for j in range(6)]
        vxx = []
        for i, j in ut:
            s_ij = Qxx[i][j] + kq[i][0] * K0[j] + kq[i][1] * K1[j]
            if i == j:
                s_ij = s_ij + w2[i]
            vxx.append(s_ij + (K0[i] * Qux0[j] + K1[i] * Qux1[j])
                       + (K0[j] * Qux0[i] + K1[j] * Qux1[i]))
        store(D, k, [d0, d1])
        for j in range(6):
            K[k, 0, j, :] = K0[j]
            K[k, 1, j, :] = K1[j]
        return Vx, vxx, gnorm

    def forward_cost(al):
        def stage(k, c):
            x, cost = c
            v = control(k, x, load(Z, k, 6), load(V, k, 2), al)
            return step_dyn(x, v), cost + stage_cost(x, v)

        x, c = fori(0, N, stage, (list(z0), zero))
        return c + state_cost(x)

    def iteration(_, carry):
        cost, done, _ = carry
        xN = load(Z, N, 6)
        Vx = [w2[j] * (xN[j] - target[j]) for j in range(6)]
        vxx = [w2[i] if i == j else zero for i, j in ut]
        _, _, gnorm = fori(0, N, backward_stage, (Vx, vxx, zero))

        # ---- line search: the first alpha that lowers the cost wins ----
        accepted = done                     # done lanes never move
        al_pick, c_best = zero, cost
        for al in alphas:
            c_new = forward_cost(al)
            newly = (~accepted) & (c_new < cost - 1e-12)
            al_pick = jnp.where(newly, al, al_pick)
            c_best = jnp.where(newly, c_new, c_best)
            accepted = accepted | newly
        take = accepted & (~done)

        # ---- commit the chosen step into Z and V, lane by lane ----
        def commit_stage(k, c):
            x, z_k = c                      # new state, old Z[k]
            v_k = load(V, k, 2)
            v = control(k, x, z_k, v_k, al_pick)
            z_next = load(Z, k + 1, 6)
            x = [jnp.where(take, a, b) for a, b in zip(step_dyn(x, v),
                                                         z_next)]
            store(V, k, [jnp.where(take, a, b) for a, b in zip(v, v_k)])
            store(Z, k + 1, x)
            return x, z_next

        fori(0, N, commit_stage, (list(z0), list(z0)))
        rel = (cost - c_best) / (jnp.abs(cost) + 1.0)
        done_n = done | (accepted & (rel < 1e-9)) | (~accepted)
        return c_best, done_n, gnorm

    cost, _, gnorm = fori(0, n_iters, iteration,
                          (cost, jnp.zeros_like(rw, dtype=jnp.bool_), zero))
    return cost, gnorm


def flops_per_solve(N: int = 15, n_iters: int = 2, n_alphas: int = 3) -> int:
    """Analytic f32 FLOP count of ONE scenario's whole solve.

    Counts the algebra of the structure-specialised `_pmpc_body` as useful
    work, transcendentals (sin/cos) as 1 FLOP — a deliberate undercount.
    Per-lane ledger:

      rollout stage    ~50 = step_dyn ~22 (sparse Ad/Sd) + stage cost ~28
      backward stage ~1190 = B cols 16, lx/lu 16, Qx 13, Qu 18,
                        Vxx@Ad 42, Qxx 48, Qux 96, Quu 108,
                        boxqp2 enumeration ~355, gains ~80, gnorm 2,
                        Vx update ~64, symmetric Vxx update ~330
      forward/alpha    ~75/stage = control law+clip 26, stage cost 28,
                        dynamics 22; +~80/alpha acceptance masking
    """
    rollout = 50 * N + 23
    backward = 1190 * N
    forward = n_alphas * (75 * N + 80)
    return rollout + n_iters * (backward + forward + 10)


def structure_residual(Ad, Sd, dt):
    """Per-lane max abs deviation of dense (6,6,L) Ad/Sd from the sparsity
    the body assumes. Exactly 0 for operators produced by
    `pmpc_fast._affine_discretization` (the x/y blocks are the same
    polynomial of the same mu, so they match bitwise); any other nonzero
    entry, or x/y-block asymmetry (e.g. a future per-axis mu), shows up
    here instead of being silently dropped by the 7-free-entry read."""
    a, b, g5 = Ad[0, 1], Ad[1, 1], Ad[5, 5]
    s01, s11, s44, s55 = Sd[0, 1], Sd[1, 1], Sd[4, 4], Sd[5, 5]
    o = jnp.ones_like(a)
    EAd = jnp.zeros_like(Ad)
    for (i, j), v in (((0, 0), o), ((2, 2), o), ((4, 4), o), ((0, 1), a),
                      ((2, 3), a), ((1, 1), b), ((3, 3), b), ((5, 5), g5)):
        EAd = EAd.at[i, j].set(v)
    ESd = jnp.zeros_like(Sd)
    for (i, j), v in (((0, 0), dt * o), ((2, 2), dt * o), ((0, 1), s01),
                      ((2, 3), s01), ((1, 1), s11), ((3, 3), s11),
                      ((4, 4), s44), ((5, 5), s55)):
        ESd = ESd.at[i, j].set(v)
    return jnp.maximum(jnp.max(jnp.abs(Ad - EAd), axis=(0, 1)),
                       jnp.max(jnp.abs(Sd - ESd), axis=(0, 1)))


def _pmpc_kernel(body, ad_ref, sd_ref, w_ref, r_ref, t_ref, z0_ref, V0_ref,
                 V_out, cost_out, gnorm_out, Z, D, K):
    """Triton program over one block of scenarios: row loads into lists,
    the body with the outputs as stage storage, row stores."""
    rows = lambda ref, n: [ref[j, :] for j in range(n)]
    for k in range(V0_ref.shape[0]):
        for i in range(2):
            V_out[k, i, :] = V0_ref[k, i, :]
    cost, gnorm = body(rows(ad_ref, 3), rows(sd_ref, 4), rows(w_ref, 6),
                       r_ref[0, :], rows(t_ref, 6), rows(z0_ref, 6),
                       Z, V_out, D, K)
    cost_out[0, :] = cost
    gnorm_out[0, :] = gnorm


def padded_size(B: int) -> int:
    """Batch rounded up to a whole number of Triton blocks."""
    return -(-B // BLOCK) * BLOCK


@functools.partial(jax.jit, static_argnames=(
    "dt", "u_bound", "g", "n_iters", "n_alphas", "route"))
def pmpc_solve(Ad, Sd, wdiag, rw, target, z0, V0, dt: float,
               u_bound: float = 0.6, g: float = -9.81, n_iters: int = 3,
               n_alphas: int = 4, route: str = "xla"):
    """Batch-last layout: Ad/Sd (6,6,B), wdiag/target/z0 (6,B), rw (B,),
    V0 (N,2,B); any B. Returns (V (N,2,B), cost (B,), gnorm (B,)).

    `route` picks how the body runs (see module docstring); the Triton
    routes pad B to a multiple of `BLOCK` with copies of the last lane and
    strip the padding after.
    """
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; expected one of {ROUTES}")
    N = V0.shape[0]
    B = V0.shape[-1]
    dtype = V0.dtype
    body = functools.partial(_pmpc_body, N, n_iters, n_alphas, float(g),
                             dt, u_bound)
    # Only the free entries of the structured operators enter the body:
    # Ad = blkdiag([[1,a],[0,b]] x2, diag(1, g)), Sd = dt-diagonal + the
    # same pattern.
    ad3 = jnp.stack([Ad[0, 1], Ad[1, 1], Ad[5, 5]]).astype(dtype)
    sd4 = jnp.stack([Sd[0, 1], Sd[1, 1], Sd[4, 4], Sd[5, 5]]).astype(dtype)
    # Structure guard: inputs outside the implied sparsity would otherwise
    # be silently mis-solved. A violating lane gets its certificates
    # poisoned to +inf below — every downstream consumer (self-escalation,
    # CI gates) treats that as "uncertified" loudly.
    bad_structure = structure_residual(Ad, Sd, dt) > 1e-6
    ins = (ad3, sd4, wdiag.astype(dtype), rw[None, :].astype(dtype),
           target.astype(dtype), z0.astype(dtype), V0)
    store_shapes = [(N + 1, 6), (N, 2), (N, 2, 6)]      # Z, D, K

    if route == "xla":
        rows = lambda x: [x[j] for j in range(x.shape[0])]
        Vref = jax.new_ref(V0)
        Z, D, K = (jax.new_ref(jnp.zeros(s + (B,), dtype))
                   for s in store_shapes)
        cost, gnorm = body(rows(ad3), rows(sd4), rows(ins[2]), ins[3][0],
                           rows(ins[4]), rows(ins[5]), Z, Vref, D, K)
        V = Vref[...]
    else:
        Bp = padded_size(B)
        pad = lambda x: jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, Bp - B)],
                                mode="edge")

        def spec(lead):
            return pl.BlockSpec(lead + (BLOCK,),
                                lambda i: (0,) * len(lead) + (i,))

        V, cost, gnorm, *_ = pl.pallas_call(
            functools.partial(_pmpc_kernel, body),
            grid=(Bp // BLOCK,),
            in_specs=[spec((3,)), spec((4,)), spec((6,)), spec((1,)),
                      spec((6,)), spec((6,)), spec((N, 2))],
            out_specs=[spec((N, 2)), spec((1,)), spec((1,))]
            + [spec(s) for s in store_shapes],
            out_shape=[jax.ShapeDtypeStruct(s + (Bp,), dtype)
                       for s in [(N, 2), (1,), (1,)] + store_shapes],
            backend="triton",
            compiler_params=pltr.CompilerParams(
                num_warps=BLOCK // 32, num_stages=1),
            interpret=route == "interpret",
            name="pmpc_whole_solve",
        )(*map(pad, ins))
        V, cost, gnorm = V[..., :B], cost[0, :B], gnorm[0, :B]
    inf = jnp.asarray(jnp.inf, dtype)
    cost = jnp.where(bad_structure, inf, cost)
    gnorm = jnp.where(bad_structure, inf, gnorm)
    return V, cost, gnorm
