"""PPO in JAX/Optax — the replacement for the reference's torch RL worker
(`LMPC/src/controller/rlmpc2.py:33-107, 536-943`).

Faithful algorithmic surface:

- actor-critic MLPs with tanh activations and orthogonal init (gain sqrt(2)),
  learned state-independent log_std clamped to [log(std_min), log(std_max)]
  (`Policy`, rlmpc2.py:33-80);
- GAE(gamma, lambda) (`compute_gae`, rlmpc2.py:592-599);
- clipped surrogate + value MSE + entropy bonus, grad-norm clip 0.5, Adam
  with weight decay (rlmpc2.py:775-821);
- Welford online observation normalisation (rlmpc2.py:552-665);
- logit-space action on the 34 MPC model parameters with EMA smoothing and
  smooth clipping (rlmpc2.py:606-616, 746-759).

Everything is a pure function of explicit state, so the collect->GAE->update
pipeline compiles into one XLA program and data-parallelises over a device
mesh (grads reduced with psum) instead of running in a separate process.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax


# --------------------------------------------------------------------------
# Policy network
# --------------------------------------------------------------------------

def dense_init(rng, in_dim: int, out_dim: int, kernel_init):
    """One dense layer's parameters, {"kernel" (in, out), "bias" (out,)}."""
    return {"kernel": kernel_init(rng, (in_dim, out_dim), jnp.float32),
            "bias": jnp.zeros((out_dim,), jnp.float32)}


def dense(p, x):
    return x @ p["kernel"] + p["bias"]


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """Tanh MLP actor + critic with learned state-independent log_std.

    `init` returns {"params": {"actor_0": {"kernel", "bias"}, ...,
    "actor_out", "critic_0", ..., "critic_out", "log_std"}} — the tree of
    the Flax module this replaces, so its checkpoints restore unchanged.
    Dense kernels are orthogonal with gain sqrt(2), biases zero.
    """

    act_dim: int
    hidden_size: int = 64
    hidden_layers: int = 2
    std_init: float = 0.1
    std_min: float = 1e-2
    std_max: float = 2.0

    def _layers(self, in_dim: int):
        dims = [in_dim] + [self.hidden_size] * self.hidden_layers
        for head, out in (("actor", self.act_dim), ("critic", 1)):
            for i in range(self.hidden_layers):
                yield f"{head}_{i}", dims[i], dims[i + 1]
            yield f"{head}_out", dims[-1], out

    def init(self, rng, obs: jnp.ndarray):
        orth = jax.nn.initializers.orthogonal(np.sqrt(2))
        layers = list(self._layers(obs.shape[-1]))
        keys = jax.random.split(rng, len(layers))
        params = {name: dense_init(k, i, o, orth)
                  for k, (name, i, o) in zip(keys, layers)}
        params["log_std"] = jnp.full((self.act_dim,), np.log(self.std_init),
                                     jnp.float32)
        return {"params": params}

    def apply(self, params, obs: jnp.ndarray):
        p = params["params"]
        h = obs
        for i in range(self.hidden_layers):
            h = jnp.tanh(dense(p[f"actor_{i}"], h))
        mean = dense(p["actor_out"], h)
        v = obs
        for i in range(self.hidden_layers):
            v = jnp.tanh(dense(p[f"critic_{i}"], v))
        value = dense(p["critic_out"], v)[..., 0]
        log_std = jnp.clip(p["log_std"], np.log(self.std_min),
                           np.log(self.std_max))
        return mean, jnp.exp(log_std), value


def normal_logp(x, mean, std):
    z = (x - mean) / std
    return jnp.sum(-0.5 * z * z - jnp.log(std) - 0.5 * np.log(2 * np.pi),
                   axis=-1)


def normal_entropy(std):
    return jnp.sum(0.5 * (1.0 + np.log(2 * np.pi)) + jnp.log(std), axis=-1)


# --------------------------------------------------------------------------
# Welford online normalisation
# --------------------------------------------------------------------------

class WelfordState(NamedTuple):
    mean: jnp.ndarray
    m2: jnp.ndarray
    count: jnp.ndarray


def welford_init(dim: int, dtype=jnp.float32) -> WelfordState:
    return WelfordState(jnp.zeros(dim, dtype), jnp.zeros(dim, dtype),
                        jnp.zeros((), dtype))


def welford_update(s: WelfordState, x: jnp.ndarray) -> WelfordState:
    count = s.count + 1.0
    delta = x - s.mean
    mean = s.mean + delta / count
    m2 = s.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_normalize(s: WelfordState, x: jnp.ndarray) -> jnp.ndarray:
    var = jnp.where(s.count > 1.0, s.m2 / jnp.maximum(s.count - 1.0, 1.0),
                    jnp.ones_like(s.m2) * 1e-6)
    std = jnp.sqrt(jnp.maximum(var, 1e-12))
    return (x - s.mean) / (std + 1e-8)


# --------------------------------------------------------------------------
# GAE
# --------------------------------------------------------------------------

def compute_gae(rewards, values, dones, last_value, gamma=0.99, lam=0.95):
    """rewards/values/dones: (T,); returns advantages (T,). Pure scan
    transcription of `rlmpc2.py:592-599`."""
    values_ext = jnp.concatenate([values, last_value[None]])

    def step(gae, inp):
        r, v, v_next, d = inp
        delta = r + gamma * v_next * (1.0 - d) - v
        gae = delta + gamma * lam * (1.0 - d) * gae
        return gae, gae

    _, adv = jax.lax.scan(
        step, jnp.zeros((), rewards.dtype),
        (rewards, values_ext[:-1], values_ext[1:], dones), reverse=True)
    return adv


# --------------------------------------------------------------------------
# Logit-space parameter action (the 34 MPC model params are the action space)
# --------------------------------------------------------------------------

class ParamActionConfig(NamedTuple):
    k_max: float = 2.0            # max_param_abs (`run.py:139`)
    max_delta: float = 0.02       # max_delta_abs (`run.py:140`)
    action_scale: float = 1.0
    min_k: float = 1e-2
    ceiling_margin: float = 0.1   # max(1e-3, 0.05*k_max)
    ema_alpha: float = 0.5        # shm_smooth_alpha
    max_per_dim_rms: float = 0.5


def smooth_clip(x, min_v, max_v, margin=1e-3):
    center = (max_v + min_v) / 2.0
    scale = (max_v - min_v) / 2.0 - margin
    return center + scale * jnp.tanh((x - center) / scale)


def apply_param_action(current_k: jnp.ndarray, raw_action: jnp.ndarray,
                       cfg: ParamActionConfig) -> jnp.ndarray:
    """z_new = logit(k/k_max) + raw*max_delta*scale; k = k_max sigmoid(z_new);
    then EMA + smooth clip (`rlmpc2.py:606-616, 746-759`)."""
    delta_z = raw_action * (cfg.max_delta * cfg.action_scale)
    # auto-damp overlarge steps (`rlmpc2.py:691-696`)
    per_dim_rms = jnp.linalg.norm(delta_z) / np.sqrt(delta_z.shape[-1])
    damp = jnp.where(per_dim_rms > cfg.max_per_dim_rms,
                     cfg.max_per_dim_rms / (per_dim_rms + 1e-12), 1.0)
    delta_z = delta_z * damp
    min_frac = cfg.min_k / cfg.k_max
    frac = jnp.clip(current_k / cfg.k_max, min_frac, 1.0 - 1e-6)
    z_new = jax.scipy.special.logit(frac) + delta_z
    k_new = cfg.k_max * jax.nn.sigmoid(z_new)
    smoothed = cfg.ema_alpha * k_new + (1.0 - cfg.ema_alpha) * current_k
    return smooth_clip(smoothed, cfg.min_k, cfg.k_max - cfg.ceiling_margin)


# --------------------------------------------------------------------------
# Reward shaping
# --------------------------------------------------------------------------

class RewardConfig(NamedTuple):
    sigma_pos: float = 0.02
    sigma_vel: float = 0.02
    w_pos: float = 60.0
    w_vel: float = 30.0
    w_change: float = 1e-3
    w_d_ctrl: float = 5.0
    success_bonus: float = 20.0
    oob_penalty: float = 20.0
    contact_penalty: float = 10.0
    tray_limit_x: float = 0.2
    tray_limit_y: float = 0.15
    time_penalty_rate: float = 1e-4


def prox_reward(pos_err, vel_err, cfg: RewardConfig):
    """Gaussian proximity; note vel term multiplies the pos term
    (`rlmpc2.py:601-604`)."""
    pos_term = jnp.exp(-(pos_err**2) / (2 * cfg.sigma_pos**2))
    vel_term = jnp.exp(-(vel_err**2) / (2 * cfg.sigma_vel**2))
    return cfg.w_pos * pos_term + cfg.w_vel * pos_term * vel_term


def shaped_reward(state, target, control, prev_control, delta_z_norm,
                  time_penalty, in_contact, cfg: RewardConfig):
    """Full reward of `rlmpc2.py:703-740`. Returns (reward, done, oob)."""
    pos = jnp.stack([state[0], state[2]])
    vel = jnp.stack([state[1], state[3]])
    tpos = jnp.stack([target[0], target[2]])
    pos_err = jnp.linalg.norm(tpos - pos)
    vel_err = jnp.linalg.norm(vel)
    r = prox_reward(pos_err, vel_err, cfg)
    r = r - cfg.w_change * delta_z_norm
    r = r - cfg.w_d_ctrl * jnp.sum(jnp.abs(control - prev_control))
    r = r - time_penalty
    r = r + jnp.where((pos_err < 0.01) & (vel_err < 0.01), cfg.success_bonus, 0.0)
    oob = (jnp.abs(state[0]) > cfg.tray_limit_x) | \
          (jnp.abs(state[2]) > cfg.tray_limit_y)
    r = r - jnp.where(oob, cfg.oob_penalty, 0.0)
    r = r - jnp.where(in_contact == 0.0, cfg.contact_penalty, 0.0)
    return r, oob


# --------------------------------------------------------------------------
# PPO update
# --------------------------------------------------------------------------

class PPOConfig(NamedTuple):
    lr: float = 3e-4
    weight_decay: float = 1e-5
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    epochs: int = 8
    minibatch_size: int = 64
    max_grad_norm: float = 0.5
    gamma: float = 0.99
    gae_lambda: float = 0.95


class Batch(NamedTuple):
    obs: jnp.ndarray        # (T, obs_dim)
    actions: jnp.ndarray    # (T, act_dim)
    logps: jnp.ndarray      # (T,)
    advantages: jnp.ndarray # (T,)
    returns: jnp.ndarray    # (T,)


def make_optimizer(cfg: PPOConfig) -> optax.GradientTransformation:
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adamw(cfg.lr, weight_decay=cfg.weight_decay),
    )


def ppo_loss(params, model: ActorCritic, batch: Batch, cfg: PPOConfig):
    mean, std, value = model.apply(params, batch.obs)
    logp = normal_logp(batch.actions, mean, std)
    ratio = jnp.exp(logp - batch.logps)
    surr1 = ratio * batch.advantages
    surr2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * batch.advantages
    policy_loss = -jnp.mean(jnp.minimum(surr1, surr2))
    value_loss = jnp.mean((value - batch.returns) ** 2)
    entropy = jnp.mean(normal_entropy(std))
    loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
    return loss, (policy_loss, value_loss, entropy)


# --------------------------------------------------------------------------
# Global replay buffer (the reference's SECOND PPO pass, rlmpc2.py:823-874:
# after each local update, 25% of the rollout is subsampled into a global
# buffer; when it holds >= rollout_len transitions, a full PPO pass runs over
# it — GAE over insertion order, bootstrapped from the last entry — and the
# buffer clears)
# --------------------------------------------------------------------------

class ReplayBuffer(NamedTuple):
    """Fixed-capacity insertion-ordered buffer (pure pytree, jit-safe)."""

    obs: jnp.ndarray        # (C, obs_dim)
    actions: jnp.ndarray    # (C, act_dim)
    logps: jnp.ndarray      # (C,)
    rewards: jnp.ndarray    # (C,)
    values: jnp.ndarray     # (C,)
    dones: jnp.ndarray      # (C,)
    size: jnp.ndarray       # () int32, valid prefix length


def replay_init(capacity: int, obs_dim: int, act_dim: int,
                dtype=jnp.float32) -> ReplayBuffer:
    return ReplayBuffer(
        obs=jnp.zeros((capacity, obs_dim), dtype),
        actions=jnp.zeros((capacity, act_dim), dtype),
        logps=jnp.zeros((capacity,), dtype),
        rewards=jnp.zeros((capacity,), dtype),
        values=jnp.zeros((capacity,), dtype),
        dones=jnp.zeros((capacity,), dtype),
        size=jnp.zeros((), jnp.int32))


def replay_add_subsample(buf: ReplayBuffer, obs, actions, logps, rewards,
                         values, dones, rng,
                         frac: float = 0.25) -> ReplayBuffer:
    """Subsample `frac` of a flattened rollout (without replacement,
    `rlmpc2.py:822-827`) and append at the buffer's write position. The
    write offset is clamped so a full buffer is never overrun — size the
    capacity as a multiple of the per-step take (the trainers use
    capacity = rollout samples, take = 1/4 of them => flush every 4 steps).
    """
    T = obs.shape[0]
    n_take = max(1, int(T * frac))
    # Both shapes are static at trace time: fail loudly on a mis-sized
    # buffer instead of silently overwriting its tail (ADVICE r2).
    if buf.obs.shape[0] % n_take != 0:
        raise ValueError(
            f"replay capacity {buf.obs.shape[0]} must be a multiple of the "
            f"per-call take {n_take} (= max(1, int({T} * {frac}))); a "
            f"non-multiple silently overwrites the buffer tail")
    idx = jax.random.choice(rng, T, (n_take,), replace=False)
    off = jnp.minimum(buf.size, buf.obs.shape[0] - n_take)
    wr = lambda dst, src: jax.lax.dynamic_update_slice_in_dim(
        dst, src[idx].astype(dst.dtype), off, 0)
    return ReplayBuffer(
        obs=wr(buf.obs, obs), actions=wr(buf.actions, actions),
        logps=wr(buf.logps, logps), rewards=wr(buf.rewards, rewards),
        values=wr(buf.values, values), dones=wr(buf.dones, dones),
        size=jnp.minimum(buf.size + n_take,
                         jnp.asarray(buf.obs.shape[0], jnp.int32)))


def replay_maybe_update(params, opt_state, model: ActorCritic, tx,
                        buf: ReplayBuffer, cfg: PPOConfig, rng,
                        axis_name: str | None = None):
    """Run the global PPO pass iff the buffer is full, then clear it
    (`rlmpc2.py:828-874`). The fill schedule is deterministic, so under
    data-parallel shard_map every device takes the same branch and the
    pmean inside never deadlocks.

    Returns (params, opt_state, buf, did_update).
    """
    full = buf.size >= buf.obs.shape[0]

    def do_update(args):
        params, opt_state, buf = args
        _, _, last_val = model.apply(params, buf.obs[-1])
        adv = compute_gae(buf.rewards, buf.values, buf.dones, last_val,
                          cfg.gamma, cfg.gae_lambda)
        batch = Batch(obs=buf.obs, actions=buf.actions, logps=buf.logps,
                      advantages=adv, returns=adv + buf.values)
        params, opt_state, _ = ppo_update(params, opt_state, model, tx,
                                          batch, cfg, rng,
                                          axis_name=axis_name)
        return params, opt_state, buf._replace(size=jnp.zeros((), jnp.int32))

    def skip(args):
        return args

    params, opt_state, buf = jax.lax.cond(
        full, do_update, skip, (params, opt_state, buf))
    return params, opt_state, buf, full


def ppo_update(params, opt_state, model: ActorCritic, tx, batch: Batch,
               cfg: PPOConfig, rng, axis_name: str | None = None):
    """Minibatched multi-epoch PPO pass as nested scans (one XLA program).

    Advantages are normalised over the full batch (rlmpc2.py:783,790).
    If `axis_name` is given, gradients are psum-averaged across that mesh
    axis (the data-parallel replacement for the single-process learner).
    """
    T = batch.obs.shape[0]
    adv = batch.advantages
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    ret = batch.returns
    ret = (ret - ret.mean()) / (ret.std() + 1e-8)
    batch = batch._replace(advantages=adv, returns=ret)
    mb = min(cfg.minibatch_size, T)
    n_mb = max(T // mb, 1)

    grad_fn = jax.grad(ppo_loss, has_aux=True)

    def epoch(carry, rng_e):
        params, opt_state = carry
        perm = jax.random.permutation(rng_e, T)

        def minibatch(carry, idx):
            params, opt_state = carry
            take = jax.lax.dynamic_slice_in_dim(perm, idx * mb, mb)
            mb_batch = jax.tree.map(lambda x: x[take], batch)
            grads, aux = grad_fn(params, model, mb_batch, cfg)
            if axis_name is not None:
                grads = jax.lax.pmean(grads, axis_name)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), aux

        (params, opt_state), aux = jax.lax.scan(
            minibatch, (params, opt_state), jnp.arange(n_mb))
        return (params, opt_state), aux

    rngs = jax.random.split(rng, cfg.epochs)
    (params, opt_state), aux = jax.lax.scan(epoch, (params, opt_state), rngs)
    stats = jax.tree.map(lambda x: x.mean(), aux)
    return params, opt_state, stats
