"""LMPC online-RL training: MPC-in-the-loop PPO as one jitted program.

The reference runs three asynchronous processes (main sim / CasADi solver /
torch PPO) glued with shared memory (`LMPC/src/controller/rlmpc2.py:110-164`,
SURVEY.md section 3.4). Here the whole loop — MPC solve with the current
34-parameter model, plant step, reward shaping, Welford normalisation,
history stacking, action in logit-space, GAE, PPO update — is pure dataflow:

    env rollout  = lax.scan over T steps (vmapped over B parallel envs)
    train step   = rollout -> GAE -> minibatched PPO update

and data-parallelises over a device mesh with pmean'd gradients. Domain
randomisation over the plant's true parameters replaces the MjSpec recompile
loop of `LMPC/src/run.py:204-241`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from dart_tpu.adapt import ppo as ppo_mod
from dart_tpu.control import mpc as mpc_mod
from dart_tpu.models import dynamics as dyn

HISTORY_LEN = 10          # rlmpc2.py:546
N_PARAMS = dyn.LMPC_N_PARAMS
BASE_OBS_DIM = 8 + 8 + 2 + N_PARAMS   # state + target + control + current_k
OBS_DIM = HISTORY_LEN * BASE_OBS_DIM


class EnvConfig(NamedTuple):
    dt: float = 0.002
    n_mpc: int = 20
    max_episode_steps: int = 512
    target_max_dist: float = 0.1        # gen_targ MAX_DIST (`rlmpc2.py:19`)
    param_update_every: int = 8         # rlmpc2.py:742
    act_cfg: ppo_mod.ParamActionConfig = ppo_mod.ParamActionConfig()
    rew_cfg: ppo_mod.RewardConfig = ppo_mod.RewardConfig()


class LMPCEnvState(NamedTuple):
    x: jnp.ndarray                  # (8,) plant state
    ctrl_carry: Any                 # LMPCCarry
    current_k: jnp.ndarray          # (34,) policy-tuned model params
    welford: ppo_mod.WelfordState
    history: jnp.ndarray            # (H, BASE_OBS_DIM) normalised history
    prev_control: jnp.ndarray       # (2,)
    time_penalty: jnp.ndarray       # ()
    episode_step: jnp.ndarray       # () int32
    target: jnp.ndarray             # (8,)
    pvec_true: jnp.ndarray          # (34,) plant ground-truth params
    rng: jnp.ndarray


def sample_true_params(rng) -> jnp.ndarray:
    """Domain randomisation of the plant's 34 physical parameters,
    spanning the mass {1,2,3} x friction {0.05,0.1,0.2} envelope of
    `run.py:64-65, 219-223` in the learned model's parameter space."""
    keys = jax.random.split(rng, 4)
    mass = jax.random.choice(keys[0], jnp.asarray([1.0, 2.0, 3.0]))
    fric = jax.random.choice(keys[1], jnp.asarray([0.05, 0.1, 0.2]))
    base = jax.random.uniform(keys[2], (N_PARAMS,), minval=0.05, maxval=0.3)
    p = base.at[0].set(mass).at[1].set(mass)                 # m_x, m_y
    p = p.at[6].set(fric * mass * 9.81)                      # F_s_x
    p = p.at[7].set(0.8 * fric * mass * 9.81)                # F_c_x
    p = p.at[11].set(fric * mass * 9.81)                     # F_s_y
    p = p.at[12].set(0.8 * fric * mass * 9.81)               # F_c_y
    p = p.at[9].set(0.05).at[14].set(0.05)                   # v_s
    p = p.at[10].set(0.01).at[15].set(0.01)                  # eps (smooth)
    p = p.at[4].set(0.01).at[5].set(0.01)                    # tiny k spring
    return p


def sample_target(rng) -> jnp.ndarray:
    xy = jax.random.uniform(rng, (2,), minval=-0.1, maxval=0.1)
    return jnp.zeros(8).at[0].set(xy[0]).at[2].set(xy[1])


def env_init(rng, ctlr: mpc_mod.LMPC, cfg: EnvConfig) -> LMPCEnvState:
    dtype = jnp.result_type(float)  # canonical float (f32 by default, f64 in tests)
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    init_k = jax.random.uniform(
        k3, (N_PARAMS,),
        minval=cfg.act_cfg.min_k,
        maxval=cfg.act_cfg.k_max / 2)   # mid-range jittered init (rlmpc2.py:618-623)
    return LMPCEnvState(
        x=jnp.zeros(8, dtype),
        ctrl_carry=ctlr.init_carry(dtype),
        current_k=init_k.astype(dtype),
        welford=ppo_mod.welford_init(BASE_OBS_DIM, dtype),
        history=jnp.zeros((HISTORY_LEN, BASE_OBS_DIM), dtype),
        prev_control=jnp.zeros(2, dtype),
        time_penalty=jnp.zeros((), dtype),
        episode_step=jnp.zeros((), jnp.int32),
        target=sample_target(k1).astype(dtype),
        pvec_true=sample_true_params(k2).astype(dtype),
        rng=k4,
    )


class Transition(NamedTuple):
    obs: jnp.ndarray
    action: jnp.ndarray
    logp: jnp.ndarray
    value: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray


def env_step(policy_params, model: ppo_mod.ActorCritic, ctlr: mpc_mod.LMPC,
             s: LMPCEnvState, cfg: EnvConfig):
    """One environment step: observe -> act (param tune) -> MPC solve ->
    plant step -> reward -> (auto-reset). Returns (state', Transition)."""
    rng, k_act, k_tgt, k_par = jax.random.split(s.rng, 4)

    # --- observation: Welford-normalised, history-stacked (rlmpc2.py:641-668)
    base = jnp.concatenate([s.x, s.target, s.prev_control, s.current_k])
    welford = ppo_mod.welford_update(s.welford, base)
    norm = ppo_mod.welford_normalize(welford, base)
    history = jnp.concatenate([s.history[1:], norm[None]], axis=0)
    obs = history.reshape(-1)

    # --- policy action in z-space
    mean, std, value = model.apply(policy_params, obs)
    raw_action = mean + std * jax.random.normal(k_act, mean.shape)
    logp = ppo_mod.normal_logp(raw_action, mean, std)
    delta_z = raw_action * (cfg.act_cfg.max_delta * cfg.act_cfg.action_scale)
    do_update = (s.episode_step % cfg.param_update_every) == 0
    k_new = ppo_mod.apply_param_action(s.current_k, raw_action, cfg.act_cfg)
    current_k = jnp.where(do_update, k_new, s.current_k)

    # --- MPC solve with the tuned model parameters
    carry, u, _ = ctlr.solve(s.ctrl_carry, s.x, s.target, current_k)

    # --- plant step with ground-truth params
    x_next = dyn.rk4_step(dyn.lmpc_dynamics, s.x, u, s.pvec_true, cfg.dt)

    # --- reward (analytic plant: always in contact)
    reward, oob = ppo_mod.shaped_reward(
        x_next, s.target, u, s.prev_control, jnp.linalg.norm(delta_z),
        s.time_penalty, jnp.ones(()), cfg.rew_cfg)
    episode_step = s.episode_step + 1
    done = oob | (episode_step >= cfg.max_episode_steps)

    # --- auto-reset on done (replaces the reset-event barrier, run.py:204-254)
    def reset_state():
        dtype = s.x.dtype
        return LMPCEnvState(
            x=jnp.zeros(8, dtype),
            ctrl_carry=ctlr.init_carry(dtype),
            current_k=current_k,
            welford=welford,
            history=jnp.zeros_like(history),
            prev_control=jnp.zeros(2, dtype),
            time_penalty=jnp.zeros((), dtype),
            episode_step=jnp.zeros((), jnp.int32),
            target=sample_target(k_tgt).astype(dtype),
            pvec_true=sample_true_params(k_par).astype(dtype),
            rng=rng,
        )

    def cont_state():
        return LMPCEnvState(
            x=x_next, ctrl_carry=carry, current_k=current_k, welford=welford,
            history=history, prev_control=u,
            time_penalty=s.time_penalty + cfg.rew_cfg.time_penalty_rate,
            episode_step=episode_step, target=s.target,
            pvec_true=s.pvec_true, rng=rng)

    s_next = jax.lax.cond(done, reset_state, cont_state)
    return s_next, Transition(obs=obs, action=raw_action, logp=logp,
                              value=value, reward=reward,
                              done=done.astype(jnp.float32))


def collect_rollout(policy_params, model, ctlr, s: LMPCEnvState,
                    cfg: EnvConfig, T: int):
    def step(s, _):
        return env_step(policy_params, model, ctlr, s, cfg)

    s, traj = jax.lax.scan(step, s, None, length=T)
    # bootstrap value for GAE
    base = jnp.concatenate([s.x, s.target, s.prev_control, s.current_k])
    norm = ppo_mod.welford_normalize(s.welford, base)
    history = jnp.concatenate([s.history[1:], norm[None]], axis=0)
    _, _, last_value = model.apply(policy_params, history.reshape(-1))
    return s, traj, last_value


def eval_rollout(policy_params, model, ctlr, s: LMPCEnvState,
                 cfg: EnvConfig, T: int):
    """Deterministic-policy evaluation rollout that records the channels the
    reference eval driver logs (`run.py:281-287`): pos_error, u_cmd, state.
    Returns (final env state, dict of (T, ...) trajectories)."""

    def step(s, _):
        base = jnp.concatenate([s.x, s.target, s.prev_control, s.current_k])
        welford = ppo_mod.welford_update(s.welford, base)
        norm = ppo_mod.welford_normalize(welford, base)
        history = jnp.concatenate([s.history[1:], norm[None]], axis=0)
        obs = history.reshape(-1)
        mean, _, _ = model.apply(policy_params, obs)  # deterministic action
        do_update = (s.episode_step % cfg.param_update_every) == 0
        k_new = ppo_mod.apply_param_action(s.current_k, mean, cfg.act_cfg)
        current_k = jnp.where(do_update, k_new, s.current_k)
        carry, u, _ = ctlr.solve(s.ctrl_carry, s.x, s.target, current_k)
        x_next = dyn.rk4_step(dyn.lmpc_dynamics, s.x, u, s.pvec_true, cfg.dt)
        pos_err = jnp.linalg.norm(
            jnp.stack([s.target[0] - x_next[0], s.target[2] - x_next[2]]))
        s_next = s._replace(x=x_next, ctrl_carry=carry, current_k=current_k,
                            welford=welford, history=history, prev_control=u,
                            episode_step=s.episode_step + 1)
        return s_next, {"pos_error": pos_err, "u_cmd": u, "state": x_next}

    return jax.lax.scan(step, s, None, length=T)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    rng: jnp.ndarray


def make_train_step(model: ppo_mod.ActorCritic, ctlr: mpc_mod.LMPC,
                    env_cfg: EnvConfig, ppo_cfg: ppo_mod.PPOConfig,
                    rollout_len: int, axis_name: str | None = None,
                    replay: bool = False):
    """Build the jittable full training step:
    (TrainState, batched LMPCEnvState) -> (TrainState, env states, stats).

    With ``replay=True`` the step implements the reference's dual-buffer
    update (`rlmpc2.py:822-874`): the signature becomes
    (ts, env_states, ReplayBuffer) -> (ts, env_states, buf, stats) — after
    the local PPO pass, 25% of the rollout is subsampled into the buffer
    and a second, global PPO pass runs whenever it fills (every 4 steps).
    Size the buffer with `init_replay(n_envs, rollout_len)`.
    """
    tx = ppo_mod.make_optimizer(ppo_cfg)

    def train_core(ts: TrainState, env_states, buf):
        rng, k_up, k_sub, k_glob = jax.random.split(ts.rng, 4)

        def roll(s):
            return collect_rollout(ts.params, model, ctlr, s, env_cfg,
                                   rollout_len)

        env_states, traj, last_values = jax.vmap(roll)(env_states)
        adv = jax.vmap(lambda t, lv: ppo_mod.compute_gae(
            t.reward, t.value, t.done, lv, ppo_cfg.gamma,
            ppo_cfg.gae_lambda))(traj, last_values)
        returns = adv + traj.value
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        batch = ppo_mod.Batch(obs=flat(traj.obs), actions=flat(traj.action),
                              logps=flat(traj.logp), advantages=flat(adv),
                              returns=flat(returns))
        params, opt_state, stats = ppo_mod.ppo_update(
            ts.params, ts.opt_state, model, tx, batch, ppo_cfg, k_up,
            axis_name=axis_name)
        stats = {"mean_reward": traj.reward.mean(), **dict(zip(
            ("policy_loss", "value_loss", "entropy"), stats))}
        if buf is not None:
            buf = ppo_mod.replay_add_subsample(
                buf, flat(traj.obs), flat(traj.action), flat(traj.logp),
                flat(traj.reward), flat(traj.value), flat(traj.done), k_sub)
            params, opt_state, buf, did = ppo_mod.replay_maybe_update(
                params, opt_state, model, tx, buf, ppo_cfg, k_glob,
                axis_name=axis_name)
            stats["global_update"] = did.astype(jnp.float32)
        return TrainState(params, opt_state, rng), env_states, buf, stats

    if replay:
        def train_step(ts, env_states, buf):
            return train_core(ts, env_states, buf)
    else:
        def train_step(ts, env_states):
            ts, env_states, _, stats = train_core(ts, env_states, None)
            return ts, env_states, stats

    return train_step, tx


def init_replay(n_envs: int, rollout_len: int,
                dtype=jnp.float32) -> ppo_mod.ReplayBuffer:
    """Global buffer sized to one rollout's samples: 25% subsampling fills
    it in 4 train steps, matching the reference's >= rollout_len trigger."""
    return ppo_mod.replay_init(n_envs * rollout_len, OBS_DIM, N_PARAMS,
                               dtype)


def init_train_state(rng, model: ppo_mod.ActorCritic,
                     tx) -> TrainState:
    k1, k2 = jax.random.split(rng)
    params = model.init(k1, jnp.zeros(OBS_DIM))
    return TrainState(params=params, opt_state=tx.init(params), rng=k2)
