"""18-config evaluation sweep over the device mesh — the batched equivalent
of running `PMPC/launch.sh` over every world_*.xml variant.

    python -m dart_tpu.cli.sweep --targets 0.05,-0.04 0.08,0.06 --runtime 5
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--targets", nargs="+", default=["0.05,-0.04"],
                   help="comma-separated xy pairs")
    p.add_argument("--runtime", type=float, default=5.0)
    p.add_argument("--tolerance", type=float, default=0.01)
    p.add_argument("--controller", default="pmpc",
                   choices=["pmpc", "rmpc", "mppi", "lmpc"])
    p.add_argument("--checkpoint_dir", default="artifacts/lmpc/general",
                   help="lmpc only: trained policy to tune the 34 params")
    p.add_argument("--batch_major", action="store_true",
                   help="rmpc only: run each device's whole shard through "
                        "one RMPCBatch solve per control step (the "
                        "fixed-budget whole-solve path on a GPU)")
    p.add_argument("--tray_lag", default="calibrated",
                   choices=["calibrated", "legacy"],
                   help="tray tracking-lag model: 'calibrated' (default) = "
                        "the MuJoCo-measured response; 'legacy' = the r1/r2 "
                        "(40, 1) lag, ~25%% optimistic on convergence time "
                        "(kept to reproduce historical artifacts)")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU backend")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from dart_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    from dart_tpu.io.logging import to_jsonable
    from dart_tpu.io import scenes
    from dart_tpu.parallel import sweep as sweep_mod
    from dart_tpu.rollout.evaluate import (make_mppi_evaluator,
                                           make_pmpc_evaluator,
                                           make_rmpc_evaluator)

    from dart_tpu.physics import tray_object as to_mod
    # None = the evaluators' fully-calibrated default (CALIBRATED_TRAY_LAG
    # + per-shape contact dissipation). Passing the lag TUPLE explicitly
    # would silently zero roll_resist/slide_damp (`_tray_params` only
    # applies the fitted dissipation on the default path) — the r3
    # "calibrated" sweep artifacts were generated with that foot-gun and
    # thus under-damped; r4 artifacts use the true calibrated plant.
    tray_lag = to_mod.LEGACY_TRAY_LAG if args.tray_lag == "legacy" else None
    targets = tuple(tuple(float(x) for x in t.split(",")) for t in args.targets)
    dt = 0.002
    n_steps = int(args.runtime / dt)
    dtype = jnp.float64 if args.f64 else jnp.float32
    batch = scenes.sweep_grid(targets=targets, dtype=dtype)
    mesh = sweep_mod.make_mesh()
    if args.batch_major:
        if args.controller != "rmpc":
            p.error("--batch_major currently supports --controller rmpc")
        from dart_tpu.rollout.evaluate import make_rmpc_batch_evaluator
        ev = make_rmpc_batch_evaluator(n_steps=n_steps, dt=dt,
                                       control_every=5, warmup_steps=250,
                                       tol=args.tolerance, tray_lag=tray_lag)
        res, agg = sweep_mod.run_sweep_batched(ev, batch, mesh)
    elif args.controller == "lmpc":
        # Trained-policy LMPC on the contact plant (`run.py:243-311`).
        import numpy as np

        from dart_tpu.adapt import lmpc_trainer as trainer
        from dart_tpu.adapt import ppo as ppo_mod
        from dart_tpu.io import checkpoint as ckpt
        from dart_tpu.rollout.evaluate import make_lmpc_evaluator

        model = ppo_mod.ActorCritic(act_dim=trainer.N_PARAMS)
        tx = ppo_mod.make_optimizer(ppo_mod.PPOConfig())
        ts = trainer.init_train_state(jax.random.PRNGKey(0), model, tx)
        restored = ckpt.load_agent(
            args.checkpoint_dir, "best_agent",
            template={"params": ts.params, "opt_state": ts.opt_state,
                      "episode": np.asarray(0), "return": np.asarray(0.0)})
        if restored is None:
            p.error(f"no checkpoint in {args.checkpoint_dir}; train with "
                    "`python -m dart_tpu.cli lmpc --train` first")
        params = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                              restored["params"])
        ev0 = make_lmpc_evaluator(params, model, n_steps=n_steps, dt=dt,
                                  control_every=5, warmup_steps=250,
                                  tol=args.tolerance, tray_lag=tray_lag)

        def ev(k, m, mu, t):
            # deterministic per-scenario seed for the param-vector init
            seed = (jnp.round(t[0] * 1e4).astype(jnp.int32) * 7919
                    + jnp.round(t[1] * 1e4).astype(jnp.int32) * 104729
                    + jnp.round(mu * 1e3).astype(jnp.int32) * 31
                    + jnp.round(m * 10).astype(jnp.int32))
            return ev0(k, m, mu, t, jax.random.fold_in(
                jax.random.PRNGKey(0), seed))

        res, agg = sweep_mod.run_sweep(ev, batch, mesh)
    else:
        maker = {"pmpc": make_pmpc_evaluator, "rmpc": make_rmpc_evaluator,
                 "mppi": make_mppi_evaluator}[args.controller]
        ev = maker(n_steps=n_steps, dt=dt, control_every=5, warmup_steps=250,
                   tol=args.tolerance, tray_lag=tray_lag)
        res, agg = sweep_mod.run_sweep(ev, batch, mesh)

    rows = []
    from dart_tpu.physics.tray_object import SHAPES
    for i in range(batch.size):
        rows.append({
            "object": SHAPES[int(batch.shape_id[i])],
            "mass": float(batch.mass[i]),
            "mu": float(batch.mu[i]),
            "target": [float(x) for x in batch.target_xy[i]],
            "converged": bool(res.metrics.converged[i]),
            "sse_mm": round(float(res.metrics.steady_state_error[i]) * 1e3, 2),
            "conv_time_s": round(float(res.metrics.convergence_time[i]), 3),
            "effort": round(float(res.metrics.control_effort[i]), 4),
        })
    summary = {
        "controller": args.controller,
        "n": int(float(agg.n)),
        "success_rate": float(agg.n_converged) / float(agg.n),
        "mean_sse_mm": round(float(agg.mean_sse) * 1e3, 3),
        "mean_conv_time_s": round(float(agg.mean_conv_time), 3),
        "mean_effort": round(float(agg.mean_effort), 4),
        "devices": len(jax.devices()),
        "tray_lag": args.tray_lag,
    }
    print(json.dumps(to_jsonable({"summary": summary,
                                  "scenarios": rows}), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
