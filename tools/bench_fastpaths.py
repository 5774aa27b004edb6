"""Micro-benchmark: structure-exploiting (closed-form) linearisation vs the
generic jacfwd/hessian path, for the RMPC and LMPC OCPs on the batch-major
solver. Runs on the default backend, or the CPU with --cpu.

Usage: python tools/bench_fastpaths.py [--cpu] [--batch 1024]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--n", type=int, default=12, help="horizon")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from dart_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from dart_tpu.models import dynamics as dyn
    from dart_tpu.solver import ilqr, ocp as ocp_mod

    B, N = args.batch, args.n
    cfg = ilqr.ILQRConfig(max_iters=args.iters, al_iters=2, n_alphas=4)
    rng = np.random.default_rng(0)

    def bench(name, ocp, params, aux, z0, V0):
        # The reps run INSIDE one jitted scan: one dispatch per timed call,
        # so host dispatch overhead does not enter the per-solve time.
        @jax.jit
        def many(z, V):
            def f(c, i):
                sol = ilqr.solve_batch(ocp, cfg, params, aux,
                                       z + 1e-4 * i, V)
                return c + jnp.sum(sol.V), None

            acc, _ = jax.lax.scan(f, jnp.zeros((), z.dtype),
                                  jnp.arange(args.reps, dtype=z.dtype))
            return acc

        fn_once = jax.jit(lambda z, V: ilqr.solve_batch(ocp, cfg, params,
                                                        aux, z, V).V)
        t0 = time.perf_counter()
        out = many(z0, V0)
        out.block_until_ready()
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        many(z0 + 1e-3, V0).block_until_ready()
        total_s = time.perf_counter() - t0
        dt_s = total_s / args.reps
        print(json.dumps({
            "case": name, "batch": B, "horizon": N,
            "compile_s": round(compile_s, 2),
            "ms_per_batch_solve": round(dt_s * 1e3, 3),
            "solves_per_sec": round(B / dt_s),
        }))
        return fn_once(z0, V0)

    # ---- LMPC (nz=10, transcendental-heavy Stribeck dynamics) ----
    pvec = jnp.asarray(rng.uniform(0.05, 0.4, (B, 34)), jnp.float32)
    aux = ocp_mod.LMPCAux(
        target=jnp.asarray(rng.uniform(-0.08, 0.08, (B, 8)) *
                           np.array([1, 0, 1, 0, 0, 0, 0, 0]), jnp.float32),
        Q=jnp.tile(jnp.asarray([200.0, 2, 200, 2, 0, 0, 0, 0], jnp.float32),
                   (B, 1)),
        R=jnp.tile(jnp.asarray([0.1, 0.1, 1.0, 1.0], jnp.float32), (B, 1)),
        Qt=jnp.tile(jnp.asarray([200.0, 2, 200, 2, 0, 0, 0, 0], jnp.float32),
                    (B, 1)))
    z0 = jnp.zeros((B, 10), jnp.float32)
    V0 = jnp.zeros((B, N, 2), jnp.float32)
    v_f = bench("lmpc_fast", ocp_mod.make_lmpc_ocp(fast=True), pvec, aux,
                z0, V0)
    v_s = bench("lmpc_generic", ocp_mod.make_lmpc_ocp(fast=False), pvec, aux,
                z0, V0)
    print("lmpc max |dV| fast vs generic:",
          float(jnp.max(jnp.abs(v_f - v_s))))

    # ---- RMPC slew-exact (nz=6, constrained AL) ----
    theta = jnp.asarray(rng.normal(0, 0.2, (B, 14)), jnp.float32)
    params = dyn.RMPCParams(theta=theta)
    ref = jnp.tile(jnp.asarray([0.05, 0, -0.03, 0], jnp.float32),
                   (B, N + 1, 1))
    raux = ocp_mod.RMPCAux(ref=ref, Qp=jnp.full(B, 100.0, jnp.float32),
                           Qv=jnp.full(B, 1.0, jnp.float32),
                           Ru=jnp.full(B, 0.5, jnp.float32),
                           Rdu=jnp.full(B, 5.0, jnp.float32))
    z0r = jnp.zeros((B, 6), jnp.float32)
    r_f = bench("rmpc_du_fast", ocp_mod.make_rmpc_ocp_du(fast=True), params,
                raux, z0r, V0)
    r_s = bench("rmpc_du_generic", ocp_mod.make_rmpc_ocp_du(fast=False),
                params, raux, z0r, V0)
    print("rmpc max |dV| fast vs generic:",
          float(jnp.max(jnp.abs(r_f - r_s))))


if __name__ == "__main__":
    main()
