"""PMPC experiment driver — the `PMPC/main_parallel_enhanced.py` equivalent.

    python -m dart_tpu.cli.pmpc --target 0.05 -0.04 --object_name cube \
        --mass 1.0 --friction 0.1 --runtime 6 --tolerance 0.01

Runs the jitted closed loop against the contact-plant oracle (add
--full_stack for the arm-in-the-loop world) and writes the reference's
17-channel npz log schema with derived metrics.
"""

import argparse
import json

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target", type=float, nargs=2, default=[0.05, -0.04])
    p.add_argument("--object_name", default="cube",
                   choices=["cube", "cylinder", "sphere"])
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--friction", type=float, default=0.1)
    p.add_argument("--runtime", type=float, default=6.0)
    p.add_argument("--tolerance", type=float, default=0.01)
    p.add_argument("--no_tune", action="store_true",
                   help="use general weights instead of per-object tuning")
    p.add_argument("--full_stack", action="store_true",
                   help="run the dual-arm physics world instead of the "
                        "tray-lag plant")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--video", default=None, metavar="MP4_PATH",
                   help="with --full_stack: render the episode to a "
                        "scene-true arms+tray+object mp4 (software "
                        "rasteriser over chain.fk — no GL needed)")
    p.add_argument("--stream", default=None, metavar="RING_PATH",
                   help="stream per-step telemetry records from inside the "
                        "jitted loop through the native C++ ring buffer "
                        "(io.streaming.TelemetryTap); read back with "
                        "io.ringlog.RingLogger.read")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU backend")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from dart_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.io.logging import EpisodeLog, to_jsonable
    from dart_tpu.models import dynamics as dyn
    from dart_tpu.physics import tray_object as to_mod
    from dart_tpu.physics.tray_object import _KAPPA_INV
    from dart_tpu.rollout.evaluate import make_pmpc_evaluator
    from dart_tpu.utils.timing import timed_call

    if args.video and not args.full_stack:
        build_parser().error("--video requires --full_stack (the plant-only "
                             "path has no arms to render)")
    dtype = jnp.float64 if args.f64 else jnp.float32
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    dt = 0.002
    n_steps = int(args.runtime / dt)

    if args.full_stack:
        from dart_tpu.rollout import full_stack as fs
        scene = fs.make_scene(dt=dt, dtype=dtype)
        obj_params = to_mod.make_params(args.object_name, args.mass,
                                        args.friction, dtype=dtype)
        # reference controller discretization Ts = sim dt
        # (`main_parallel.py:108`)
        ctlr = mpc_mod.PMPC(N=15, dt=dt, u_bound=0.6,
                            cfg=mpc_mod.ilqr.ILQRConfig(max_iters=10))
        weights = (mpc_mod.PMPC_WEIGHTS["general"] if args.no_tune
                   else mpc_mod.PMPC_WEIGHTS[args.object_name])
        # High-friction schedule for sliding shapes (mpc.
        # pmpc_schedule_weights; sphere handled by the rolling-aware model)
        weights = jax.tree.map(jnp.asarray, mpc_mod.pmpc_schedule_weights(
            weights, args.friction, args.object_name != "sphere"))
        params = dyn.PMPCParams(mu=args.friction, dt=dt)
        target6 = jnp.asarray([args.target[0], 0, args.target[1], 0, 0.43, 0],
                              dtype)

        def solve_fn(c, obs, t):
            return ctlr.solve(c, obs, t, params, weights)

        def run():
            return fs.run_full_stack(
                scene, solve_fn, ctlr.init_carry(dtype),
                fs.init_full_state(dtype), target6, obj_params,
                n_steps=n_steps, dt=dt, control_every=5, warmup_steps=250,
                qp_iters=40, record_joints=bool(args.video))

        out_t, compile_s, run_s = timed_call(run)
        if args.video:
            ps, thetas, us, qLs, qRs, _ = out_t
            from dart_tpu.io.video import save_scene_video
            save_scene_video(args.video, qLs, qRs, ps, thetas, args.target,
                             scene=scene)
        else:
            ps, thetas, us, _ = out_t
        ps = np.asarray(ps)
        us = np.asarray(us)
    else:
        tap = None
        if args.stream:
            from dart_tpu.io.streaming import (EPISODE_STREAM_DTYPE,
                                               TelemetryTap)
            tap = TelemetryTap(args.stream, EPISODE_STREAM_DTYPE,
                               capacity_records=1 << 16)
        ev = make_pmpc_evaluator(n_steps=n_steps, dt=dt, control_every=5,
                                 warmup_steps=250, tol=args.tolerance,
                                 tap=tap)
        kinv = jnp.asarray(_KAPPA_INV[args.object_name], dtype)

        def run():
            return jax.jit(ev)(kinv, jnp.asarray(args.mass, dtype),
                               jnp.asarray(args.friction, dtype),
                               jnp.asarray(args.target, dtype))

        if tap is not None:
            # streaming: execute exactly once (timed_call's warm reps
            # would push duplicate records through the ring)
            import time as _time
            t0 = _time.perf_counter()
            res = jax.block_until_ready(run())
            compile_s, run_s = _time.perf_counter() - t0, float("nan")
        else:
            res, compile_s, run_s = timed_call(run)
        m = res.metrics
        out = {
            "steady_state_error": float(m.steady_state_error),
            "convergence_time": float(m.convergence_time),
            "control_effort": float(m.control_effort),
            "converged": bool(m.converged),
            "compile_s": round(compile_s, 2),
            "run_s": round(run_s, 3),
            "sim_steps": n_steps,
        }
        if tap is not None:
            st = tap.stats()
            tap.close()
            out["stream"] = {"path": args.stream,
                             "records": int(st["pushed"]),
                             "dropped": int(st["dropped"])}
        print(json.dumps(to_jsonable(out)))
        return 0

    err = np.linalg.norm(ps - np.asarray(args.target), axis=1)
    below = err < args.tolerance
    out = {
        "steady_state_error": float(err[-1]),
        "convergence_time": float(np.argmax(below) * dt) if below.any()
        else float("inf"),
        "control_effort": float(np.sum(np.linalg.norm(us, axis=1)) * dt),
        "converged": bool(below.any()),
        "compile_s": round(compile_s, 2),
        "run_s": round(run_s, 3),
        "sim_steps": n_steps,
    }
    if args.log_dir:
        log = EpisodeLog()
        T = len(us)
        log.log_arrays(
            t=np.arange(T) * dt,
            X=np.stack([ps[:, 0], np.zeros(T), ps[:, 1], np.zeros(T),
                        np.zeros(T), np.zeros(T)], -1),
            U_cmd=us,
        )
        out["log_path"] = log.save_npz(args.log_dir, args.object_name,
                                       args.mass, args.friction, args.target,
                                       args.tolerance)
    print(json.dumps(to_jsonable(out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
