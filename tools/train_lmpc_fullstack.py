"""Train the LMPC 34-parameter tuner policy against the FULL physics stack
(impedance QPs + chain dynamics + rigid-grasp tray + contact object) with
the dual-buffer PPO update — the VERDICT r1 item-3 retrain: the committed
round-1 checkpoint was trained on the analytic lmpc-model plant; this one
trains where the reference trains (a full simulated world, `run.py:160-311`)
and adds the global replay pass (`rlmpc2.py:822-874`).

CPU by design: the env is host-light, fully jitted, and the train step
compiles locally in ~1 min.

Usage: python tools/train_lmpc_fullstack.py --updates 120 --envs 8
"""

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--updates", type=int, default=120)
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--rollout_len", type=int, default=64)
    ap.add_argument("--mpc_horizon", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint_dir", default="artifacts/lmpc/fullstack")
    ap.add_argument("--max_episode_steps", type=int, default=256,
                    help="control periods per episode. r5 hold curriculum "
                         "(VERDICT r4 next-8): 768 makes ~80%% of training "
                         "states POST-convergence holds (reach ~1-1.5 s, "
                         "episode 7.7 s), teaching the tuner to keep a "
                         "converged object parked, not just to reach")
    ap.add_argument("--shape_probs", nargs=3, type=float,
                    default=[1 / 3, 1 / 3, 1 / 3],
                    metavar=("CUBE", "CYL", "SPH"),
                    help="fullstack only: domain-randomisation shape "
                         "distribution (r5 sphere-heavy hold curriculum: "
                         "0.2 0.3 0.5)")
    ap.add_argument("--plant", default="fullstack",
                    choices=["fullstack", "lag"],
                    help="training plant: 'fullstack' = dual-arm world "
                         "(adapt.lmpc_fullstack); 'lag' = the calibrated "
                         "tray-lag plant with the r5 small-signal backlash "
                         "(adapt.lmpc_lagplant) — the exact plant the "
                         "batched evaluators measure on")
    args = ap.parse_args()

    from dart_tpu.adapt import lmpc_fullstack as fstr
    from dart_tpu.adapt import lmpc_trainer as trainer
    from dart_tpu.adapt import ppo as ppo_mod
    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.io import checkpoint as ckpt
    from dart_tpu.rollout import full_stack as fs

    ctrl_dt = 0.002 * 5
    ctlr = mpc_mod.LMPC(N=args.mpc_horizon, dt=ctrl_dt,
                        cfg=mpc_mod.ilqr.ILQRConfig(max_iters=4))
    ppo_cfg = ppo_mod.PPOConfig(epochs=4, minibatch_size=64)
    model = ppo_mod.ActorCritic(act_dim=trainer.N_PARAMS)

    if args.plant == "lag":
        from dart_tpu.adapt import lmpc_lagplant as lstr
        env_cfg = lstr.LagEnvConfig(
            dt=0.002, substeps=5,
            max_episode_steps=args.max_episode_steps)
        train_step, tx = lstr.make_train_step(model, ctlr, env_cfg,
                                              ppo_cfg, args.rollout_len,
                                              replay=True)
        env_init = lstr.env_init
    else:
        env_cfg = fstr.FSEnvConfig(dt=0.002, substeps=5, qp_iters=20,
                                   max_episode_steps=args.max_episode_steps,
                                   shape_probs=tuple(args.shape_probs))
        scene = fs.make_scene(dt=env_cfg.dt, dtype=jnp.float32)
        train_step, tx = fstr.make_train_step(model, ctlr, scene, env_cfg,
                                              ppo_cfg, args.rollout_len,
                                              replay=True)
        env_init = fstr.env_init
    ts = trainer.init_train_state(jax.random.PRNGKey(args.seed), model, tx)
    env_states = jax.vmap(
        lambda r: env_init(r, ctlr, env_cfg))(
            jax.random.split(jax.random.PRNGKey(args.seed + 1), args.envs))
    buf = trainer.init_replay(args.envs, args.rollout_len)

    jitted = jax.jit(train_step)
    mgr = ckpt.CheckpointManager(args.checkpoint_dir)
    t0 = time.time()
    hist = []
    for step in range(args.updates):
        ts, env_states, buf, stats = jitted(ts, env_states, buf)
        jax.block_until_ready(ts.params)
        rew = float(stats["mean_reward"])
        hist.append(rew)
        mgr.on_episode_end(ts.params, ts.opt_state, step, rew)
        print(json.dumps({
            "update": step, "mean_reward": round(rew, 3),
            "policy_loss": round(float(stats["policy_loss"]), 4),
            "value_loss": round(float(stats["value_loss"]), 4),
            "global_update": int(float(stats["global_update"])),
            "elapsed_s": round(time.time() - t0, 1)}), flush=True)
    print(json.dumps({"done": True, "updates": args.updates,
                      "reward_first": round(hist[0], 3),
                      "reward_last": round(hist[-1], 3),
                      "reward_best": round(max(hist), 3),
                      "wall_s": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
