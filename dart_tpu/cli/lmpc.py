"""LMPC train/eval driver — the `LMPC/src/run.py` equivalent.

    python -m dart_tpu.cli.lmpc --train --updates 20 --envs 8 \
        --checkpoint_dir checkpoints/general
    python -m dart_tpu.cli.lmpc --test --checkpoint_dir checkpoints/general

Training runs the fully-jitted MPC-in-the-loop PPO (domain randomisation
over the plant's 34 physical parameters replaces the MjSpec recompile of
`run.py:204-241`); gradients data-parallelise over all local devices.
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--updates", type=int, default=10,
                   help="number of PPO train steps (train mode)")
    p.add_argument("--envs", type=int, default=8)
    p.add_argument("--rollout_len", type=int, default=128)
    p.add_argument("--mpc_horizon", type=int, default=12)
    p.add_argument("--checkpoint_dir", default="checkpoints/general")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_episode_steps", type=int, default=2000)
    p.add_argument("--logdir", default="")
    p.add_argument("--env", default="general",
                   help="eval world: 'general' = randomized analytic-plant "
                        "episodes, or a named 18-grid config like "
                        "'cube_1x0_0x1' (`run.py:30-34` world_{env} "
                        "selection) evaluated on the contact plant")
    p.add_argument("--target", nargs=2, type=float, default=[0.10, 0.05],
                   help="per-env eval target (tray-frame xy)")
    p.add_argument("--tag", default="", help="log path tag (`run.py:21`)")
    args = p.parse_args(argv)
    assert not (args.train and args.test), "choose either --train or --test"
    training = args.train or not args.test

    import jax
    import numpy as np

    from dart_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from dart_tpu.adapt import lmpc_trainer as trainer
    from dart_tpu.adapt import ppo as ppo_mod
    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.io import checkpoint as ckpt
    from dart_tpu.utils.timing import Stopwatch

    ctlr = mpc_mod.LMPC(N=args.mpc_horizon, dt=0.01,
                        cfg=mpc_mod.ilqr.ILQRConfig(max_iters=4))
    env_cfg = trainer.EnvConfig(dt=0.01, max_episode_steps=1024)
    ppo_cfg = ppo_mod.PPOConfig(epochs=4, minibatch_size=64)
    model = ppo_mod.ActorCritic(act_dim=trainer.N_PARAMS)
    train_step, tx = trainer.make_train_step(model, ctlr, env_cfg, ppo_cfg,
                                             rollout_len=args.rollout_len)
    ts = trainer.init_train_state(jax.random.PRNGKey(args.seed), model, tx)

    if training:
        env_states = jax.vmap(
            lambda r: trainer.env_init(r, ctlr, env_cfg))(
                jax.random.split(jax.random.PRNGKey(args.seed + 1), args.envs))
        jitted = jax.jit(train_step)
        mgr = ckpt.CheckpointManager(args.checkpoint_dir)
        watch = Stopwatch()
        history = []
        for step in range(args.updates):
            with watch.measure("train_step"):
                ts, env_states, stats = jitted(ts, env_states)
                jax.block_until_ready(ts.params)
            rew = float(stats["mean_reward"])
            history.append(rew)
            mgr.on_episode_end(ts.params, ts.opt_state, step, rew)
            print(json.dumps({"update": step, "mean_reward": round(rew, 3),
                              "policy_loss": round(float(stats["policy_loss"]), 4),
                              "value_loss": round(float(stats["value_loss"]), 4)}))
        print(json.dumps({"done": True, "updates": args.updates,
                          "reward_first": round(history[0], 3),
                          "reward_last": round(history[-1], 3),
                          "timing": watch.summary()["train_step"]}))
        return 0

    # --- eval: load best policy, run episodes with deterministic actions
    restored = ckpt.load_agent(args.checkpoint_dir, "best_agent",
                               template={"params": ts.params,
                                         "opt_state": ts.opt_state,
                                         "episode": np.asarray(0),
                                         "return": np.asarray(0.0)})
    if restored is None:
        print(json.dumps({"error": "no checkpoint found; run --train first "
                          "(reference falls back to training, rlmpc2.py:574)"}))
        return 1
    params = restored["params"]

    if args.env != "general":
        # Per-env eval on the CONTACT plant, named like the reference's
        # world_{env}.xml selection (`run.py:30-34`): cube_1x0_0x1 etc.
        import jax.numpy as jnp

        from dart_tpu.io.results import env_name, parse_env_name
        from dart_tpu.physics import tray_object as to_mod
        from dart_tpu.rollout.evaluate import make_lmpc_evaluator

        obj, mass, mu = parse_env_name(args.env)
        obj_params = to_mod.make_params(obj, mass=mass, mu=mu)
        # --eval_episode_steps counts CONTROL steps (10 ms), like the
        # general eval path; the contact-plant evaluator's n_steps counts
        # 2 ms plant steps, so convert (control_every = 5).
        evaluate = make_lmpc_evaluator(
            params, model, n_steps=args.eval_episode_steps * 5,
            N=args.mpc_horizon, control_every=5, trace=True)
        dtype = obj_params.mass.dtype
        results, (ps, us) = jax.jit(evaluate)(
            obj_params.kappa_inv, obj_params.mass, obj_params.mu,
            jnp.asarray(args.target, dtype),
            jax.random.PRNGKey(args.seed + 3))
        pos_err = np.linalg.norm(
            np.asarray(ps)[:, :2] - np.asarray(args.target), axis=-1)
        if args.logdir:
            from dart_tpu.io.logging import EpisodicNpy
            # reference log path schema: {tag}_test/{env}.npy
            # (`results.py:22`)
            tag = args.tag or args.logdir
            store = EpisodicNpy(f"{tag}_test/{env_name(obj, mass, mu)}.npy")
            store.log("pos_error", pos_err)
            store.log("u_cmd", np.asarray(us))
            store.log("timestep", np.arange(len(pos_err)) * 0.01)
            store.save()
        m = results.metrics
        print(json.dumps({
            "env": args.env, "plant": "contact",
            "target": list(args.target),
            "converged": bool(m.converged),
            "steady_state_error_mm": round(float(m.steady_state_error) * 1e3,
                                           3),
            "convergence_time_s": float(m.convergence_time),
            "control_effort": round(float(m.control_effort), 4),
        }))
        return 0

    env_states = jax.vmap(
        lambda r: trainer.env_init(r, ctlr, env_cfg))(
            jax.random.split(jax.random.PRNGKey(args.seed + 2), args.envs))

    _, logs = jax.jit(jax.vmap(
        lambda s: trainer.eval_rollout(params, model, ctlr, s, env_cfg,
                                       args.eval_episode_steps)))(env_states)
    pos_err = np.asarray(logs["pos_error"])   # (envs, T)
    # Episodic log in the reference's .npy schema (`analyitics.py`).
    if args.logdir:
        from dart_tpu.io.logging import EpisodicNpy
        store = EpisodicNpy(f"{args.logdir}_test/general.npy")
        dtc = env_cfg.dt
        for e in range(args.envs):
            store.log("pos_error", pos_err[e])
            store.log("u_cmd", np.asarray(logs["u_cmd"][e]))
            store.log("timestep", np.arange(pos_err.shape[1]) * dtc)
            store.log("state", np.asarray(logs["state"][e]))
            store.save()
    print(json.dumps({
        "episodes": args.envs,
        "mean_final_pos_error": round(float(pos_err[:, -1].mean()), 5),
        "min_pos_error": round(float(pos_err.min()), 5),
        "success_rate_1cm": round(float((pos_err[:, -1] < 0.01).mean()), 3),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
