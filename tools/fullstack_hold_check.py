"""Post-convergence HOLD check on the full dual-arm plant (r5).

Runs the trained LMPC tuner on `adapt.lmpc_fullstack`'s environment — the
complete impedance-QP + chain-dynamics + rigid-grasp + contact world, the
highest-fidelity pure-JAX plant — for 25 s episodes on the six ROLLING
grid lanes, and records whether the object stays on the tray and how far
it wanders after the reach phase.

Context (VERDICT r4 next-3): the reduced tray-lag plant ejects marginal
rolling holds through its measured small-signal backlash; this artifact
pins down what the full-fidelity plant does with the same controller —
bounded limit cycles, no ejection — so the settled-sweep contact-loss
flags can be read as a reduced-model envelope limit rather than a
controller failure.

    PYTHONPATH=/root/repo python tools/fullstack_hold_check.py \
        --checkpoint_dir artifacts/lmpc/fullstack_r5
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint_dir", default="artifacts/lmpc/fullstack_r5")
    ap.add_argument("--out", default="artifacts/lmpc_fullstack_hold_r5.json")
    ap.add_argument("--runtime", type=float, default=25.0)
    ap.add_argument("--target", default="0.05,-0.04")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from dart_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from dart_tpu.adapt import lmpc_fullstack as fstr
    from dart_tpu.adapt import lmpc_trainer as trainer, ppo as ppo_mod
    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.io import checkpoint as ckpt
    from dart_tpu.physics import tray_object as to_mod
    from dart_tpu.rollout import full_stack as fs

    model = ppo_mod.ActorCritic(act_dim=trainer.N_PARAMS)
    tx = ppo_mod.make_optimizer(ppo_mod.PPOConfig())
    ts = trainer.init_train_state(jax.random.PRNGKey(0), model, tx)
    r = ckpt.load_agent(args.checkpoint_dir, "best_agent",
                        template={"params": ts.params,
                                  "opt_state": ts.opt_state,
                                  "episode": np.asarray(0),
                                  "return": np.asarray(0.0)})
    assert r is not None, args.checkpoint_dir
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), r["params"])

    n_ctrl = int(args.runtime / 0.01)
    env_cfg = fstr.FSEnvConfig(dt=0.002, substeps=5, qp_iters=20,
                               max_episode_steps=n_ctrl + 1)  # no reset
    ctlr = mpc_mod.LMPC(N=8, dt=0.01,
                        cfg=mpc_mod.ilqr.ILQRConfig(max_iters=4))
    scene = fs.make_scene(dt=0.002, dtype=jnp.float32)
    tx_, ty_ = (float(x) for x in args.target.split(","))
    tgt = jnp.zeros(8, jnp.float32).at[0].set(tx_).at[2].set(ty_)

    def run_lane(shape, mass, mu, seed):
        f32 = jnp.float32
        kappa = {"cylinder": [2.0, 0.0], "sphere": [2.5, 2.5]}[shape]
        obj = fstr.sample_obj_params(jax.random.PRNGKey(0))._replace(
            mass=f32(mass), mu=f32(mu),
            kappa_inv=jnp.asarray(kappa, jnp.float32),
            topple_on=to_mod.topple_on_from_kappa(
                jnp.asarray(kappa, jnp.float32)),
            roll_resist=f32(to_mod.CALIBRATED_ROLL_RESIST[shape]),
            slide_damp=f32(0.0))
        s0 = fstr.env_init(jax.random.PRNGKey(seed), ctlr, env_cfg)
        s0 = s0._replace(obj_params=obj, target=tgt)

        def stepf(s, _):
            s2, _tr = fstr.env_step(params, model, ctlr, scene, s, env_cfg)
            return s2, s2.world.obj.p

        _, ps = jax.jit(
            lambda s: jax.lax.scan(stepf, s, None, length=n_ctrl))(s0)
        ps = np.asarray(ps)
        err = np.hypot(ps[:, 0] - tx_, ps[:, 1] - ty_)
        on_tray = bool((np.abs(ps[:, 0]) < to_mod.TRAY_LIMIT_X).all()
                       and (np.abs(ps[:, 1]) < to_mod.TRAY_LIMIT_Y).all())
        half = len(err) // 2
        return {"shape": shape, "mass": mass, "mu": mu,
                "on_tray_25s": on_tray,
                "min_err_mm": round(float(err.min()) * 1e3, 1),
                "final_err_mm": round(float(err[-1]) * 1e3, 1),
                "max_err_after_5s_mm": round(float(err[500:].max()) * 1e3, 1),
                "mean_err_last_half_mm": round(
                    float(err[half:].mean()) * 1e3, 1)}

    rows = []
    for shape in ("cylinder", "sphere"):
        for mass in (1.0, 2.0):
            for mu in (0.05, 0.1, 0.2):
                row = run_lane(shape, mass, mu, seed=3)
                rows.append(row)
                print(json.dumps(row), flush=True)

    out = {"plant": "full dual-arm stack (rollout.full_stack)",
           "checkpoint": args.checkpoint_dir,
           "runtime_s": args.runtime,
           "all_on_tray": all(r["on_tray_25s"] for r in rows),
           "rows": rows}
    with open(os.path.join(REPO, args.out), "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}; all_on_tray={out['all_on_tray']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
