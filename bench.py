"""Headline benchmark: closed-loop PMPC solves per second on one GPU.

Reference baseline: the parallel PMPC implementation sustains ~80-100 Hz of
IPOPT solves on a desktop CPU core (`PMPC/README.md:266`, BASELINE.md). We
measure the same work — receding-horizon PMPC solves (nx=6, nu=2, N=15,
Ts=2 ms) inside a closed loop against the analytic plant, B=4096 scenarios —
through the whole-solve path the batch controllers take on this platform
(`ops.route`: the Triton kernel of `ops.pallas.pmpc_solve` on a GPU).

Tiers, each a jitted `lax.scan` of T closed-loop steps (solve + plant step),
timed with `block_until_ready` after a warm-up call, median of REPS calls:

  value            warm budget, 2 iterations x 3 alphas per step;
  value_adaptive   the `PMPCBatch.solve` front end as shipped (warm budget
                   + self-escalation);
  value_converged  3 chained warm rounds = 6 Newton iterations, with the
                   final plan's projected-gradient norm as the certificate.

The same line carries the closed-loop quality gate (success@1cm over the
batch after a 2.4 s episode), so the rate never decouples from solve
quality. `vs_baseline` divides by the reference's ~100 Hz IPOPT rate.

Runs only on a GPU: with no GPU it prints an error and exits nonzero.
Prints ONE JSON line on stdout.
"""

import json
import sys
import time

import numpy as np

BASELINE_HZ = 100.0          # reference IPOPT rate (`PMPC/README.md:266`)
DT = 0.002                   # reference control period (2 ms)
N = 15                       # reference horizon (`PMPC/main_parallel.py:108`)
B = 4096                     # scenarios
T = 500                      # closed-loop steps per timed call
REPS = 5


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, found platform {dev.platform!r}",
              file=sys.stderr)
        return 1
    from dart_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.models import dynamics as dyn
    from dart_tpu.ops import route as route_mod
    from dart_tpu.ops.pallas.pmpc_solve import flops_per_solve
    from dart_tpu.solver import ilqr, pmpc_fast
    from dart_tpu.solver.ocp import PMPCAux, make_pmpc_ocp

    route = route_mod.solve_route()
    rng = np.random.default_rng(0)
    targets = jnp.asarray(
        rng.uniform(-0.1, 0.1, size=(B, 6)) * np.array([1, 0, 1, 0, 0, 0]),
        jnp.float32)
    mus = jnp.asarray(rng.uniform(0.05, 0.2, size=(B,)), jnp.float32)
    aux = PMPCAux(target=targets, Qp=jnp.full(B, 300.0, jnp.float32),
                  Qv=jnp.full(B, 2.0, jnp.float32),
                  R=jnp.full(B, 0.2, jnp.float32))
    plant = dyn.discretize(dyn.pmpc_dynamics, DT)
    plant_v = jax.vmap(lambda x, u, mu: plant(x, u, dyn.PMPCParams(mu=mu,
                                                                   dt=DT)))
    x0 = jnp.zeros((B, 6), jnp.float32)
    V0 = jnp.zeros((B, N, 2), jnp.float32)

    def make_loop(solver, n_steps):
        @jax.jit
        def closed_loop(x0, V0):
            def f(c, _):
                x, V = c
                Vs = solver(x, V)
                Vn = jnp.concatenate([Vs[:, 1:], Vs[:, -1:]], axis=1)
                return (plant_v(x, Vs[:, 0], mus), Vn), None

            (xf, Vf), _ = jax.lax.scan(f, (x0, V0), None, length=n_steps)
            return xf, Vf

        return closed_loop

    def warm(x, V):
        return pmpc_fast.solve_batch_kernel(mus, aux, x, V, route=route,
                                            dt=DT, n_iters=2, n_alphas=3)[0]

    def converged(x, V):
        for _ in range(3):
            V = warm(x, V)
        return V

    ctlr = mpc_mod.PMPCBatch(N=N, dt=DT)
    wts = mpc_mod.PMPCWeights(jnp.asarray(300.0), jnp.asarray(2.0),
                              jnp.asarray(0.2))
    prm = dyn.PMPCParams(mu=mus, dt=DT)

    def adaptive(x, V):
        # carry.V is the shifted plan; the bench loop shifts once more,
        # which keeps the same receding-horizon warm-start semantics
        return ctlr.solve(mpc_mod.PMPCCarry(V=V), x, targets, prm, wts)[0].V

    out = {"metric": "pmpc_solves_per_sec_per_chip", "unit": "solves/s",
           "platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": len(jax.devices()), "route": route,
           "batch": B, "horizon": N, "steps_per_call": T, "reps": REPS}
    for key, solver in (("value", warm), ("value_adaptive", adaptive),
                        ("value_converged", converged)):
        loop = make_loop(solver, T)
        t0 = time.perf_counter()
        xf, _ = jax.block_until_ready(loop(x0, V0))
        out[f"{key}_compile_s"] = round(time.perf_counter() - t0, 3)
        if not bool(jnp.all(jnp.isfinite(xf))):
            print(f"bench: non-finite states in tier {key}", file=sys.stderr)
            return 1
        times = []
        for r in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(loop(x0 + 1e-4 * (r + 1), V0))
            times.append(time.perf_counter() - t0)
        out[key] = B * T / float(np.median(times))
        out[f"{key}_step_ms"] = [1e3 * t / T for t in times]

    xf, Vf = make_loop(warm, T)(x0, V0)
    Vsol = converged(xf, Vf)
    pgs = ilqr.projected_grad_norm(make_pmpc_ocp(dt=DT, u_bound=0.6),
                                   prm, aux, xf, Vsol)
    out["pg_max_converged"] = float(jnp.max(pgs))
    out["flops_per_solve"] = flops_per_solve(N, 2, 3)
    out["achieved_gflops"] = out["value"] * out["flops_per_solve"] / 1e9
    out["vs_baseline"] = out["value"] / BASELINE_HZ

    # Closed-loop QUALITY gate: 1200 solve-every-step iterations = 2.4 s.
    xq, _ = make_loop(warm, 1200)(x0, V0)
    err = jnp.hypot(xq[:, 0] - targets[:, 0], xq[:, 2] - targets[:, 2])
    out["quality_success_at_1cm"] = float(jnp.mean(err < 0.01))
    out["quality_mean_final_err_mm"] = float(jnp.mean(err)) * 1e3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
