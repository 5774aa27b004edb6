"""RMPC adaptive-MPC driver — the `RMPC/dev_dual/rob_ctrl.py` equivalent.

    python -m dart_tpu.cli.rmpc --object sphere --mass 1 --mu 0.1 \
        --tx 0.05 --ty -0.04 --save logs/rmpc
"""

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--object", default="cube",
                   choices=["cube", "cylinder", "sphere"])
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--mu", type=float, default=0.1)
    p.add_argument("--tx", type=float, default=0.05)
    p.add_argument("--ty", type=float, default=-0.04)
    p.add_argument("--runtime", type=float, default=6.0)
    p.add_argument("--save", default=None,
                   help="directory for the episode JSON log")
    p.add_argument("--f64", action="store_true")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    from dart_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from dart_tpu.io.logging import (episode_json_name,
                                     save_episodes_json, to_jsonable)
    from dart_tpu.physics.tray_object import _KAPPA_INV
    from dart_tpu.rollout.evaluate import make_rmpc_evaluator
    from dart_tpu.utils.timing import timed_call

    dtype = jnp.float64 if args.f64 else jnp.float32
    dt = 0.002
    n_steps = int(args.runtime / dt)
    ev = make_rmpc_evaluator(n_steps=n_steps, dt=dt, control_every=5,
                             warmup_steps=250, trace=args.save is not None)
    kinv = jnp.asarray(_KAPPA_INV[args.object], dtype)
    fn = jax.jit(lambda: ev(kinv, jnp.asarray(args.mass, dtype),
                            jnp.asarray(args.mu, dtype),
                            jnp.asarray([args.tx, args.ty], dtype)))
    out, compile_s, run_s = timed_call(fn)
    if args.save is not None:
        res, (ps, us, thetas) = out
    else:
        res = out
    m = res.metrics
    result = {
        "steady_state_error": float(m.steady_state_error),
        "convergence_time": float(m.convergence_time),
        "control_effort": float(m.control_effort),
        "converged": bool(m.converged),
        "compile_s": round(compile_s, 2),
        "run_s": round(run_s, 3),
    }
    if args.save is not None:
        ps, us = np.asarray(ps), np.asarray(us)
        err = np.linalg.norm(ps - np.array([args.tx, args.ty]), axis=1)
        episode = {
            "pos_err": err,
            "pos_err_norm": err / max(np.hypot(args.tx, args.ty), 1e-9),
            "u_cmd": us,
            "timestep": np.arange(len(us)) * dt,
            "theta_hat_final": np.asarray(thetas)[-1],
        }
        name = episode_json_name(args.object, args.mass,
                                 (args.mu, args.mu, 0.01 * args.mu),
                                 (args.tx, args.ty))
        path = os.path.join(args.save, name)
        save_episodes_json(path, [episode])
        result["log_path"] = path
    print(json.dumps(to_jsonable(result)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
