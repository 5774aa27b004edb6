import numpy as np
import jax
import jax.numpy as jnp

from dart_tpu.adapt import ppo as ppo_mod
from dart_tpu.adapt import lmpc_trainer as trainer
from dart_tpu.control import mpc as mpc_mod


def test_gae_matches_reference_loop():
    """Pure-python transcription of rlmpc2.py:592-599 as oracle."""
    rng = np.random.default_rng(0)
    T = 20
    rewards = rng.normal(size=T)
    values = rng.normal(size=T)
    dones = (rng.uniform(size=T) < 0.2).astype(float)
    last_value = 0.3
    gamma, lam = 0.99, 0.95

    vals = list(values) + [last_value]
    adv, gae = [], 0.0
    for t in reversed(range(T)):
        delta = rewards[t] + gamma * vals[t + 1] * (1 - dones[t]) - vals[t]
        gae = delta + gamma * lam * (1 - dones[t]) * gae
        adv.insert(0, gae)

    got = np.asarray(ppo_mod.compute_gae(
        jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones),
        jnp.asarray(last_value), gamma, lam))
    assert np.allclose(got, adv, atol=1e-12)


def test_welford_matches_numpy():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(200, 5)) * np.array([1, 10, 0.1, 5, 2])
    s = ppo_mod.welford_init(5, jnp.float64)
    for x in xs:
        s = ppo_mod.welford_update(s, jnp.asarray(x))
    assert np.allclose(np.asarray(s.mean), xs.mean(0), atol=1e-10)
    var = np.asarray(s.m2) / (len(xs) - 1)
    assert np.allclose(var, xs.var(0, ddof=1), atol=1e-10)
    z = np.asarray(ppo_mod.welford_normalize(s, jnp.asarray(xs[0])))
    want = (xs[0] - xs.mean(0)) / (np.sqrt(xs.var(0, ddof=1)) + 1e-8)
    assert np.allclose(z, want, atol=1e-6)


def test_param_action_bounds_and_ema():
    cfg = ppo_mod.ParamActionConfig(k_max=2.0, max_delta=0.02, min_k=1e-2,
                                    ceiling_margin=0.1)
    rng = np.random.default_rng(2)
    k = jnp.asarray(rng.uniform(0.05, 1.5, size=34))
    for scale in [0.1, 1.0, 100.0]:
        raw = jnp.asarray(rng.normal(size=34) * scale)
        k_new = ppo_mod.apply_param_action(k, raw, cfg)
        kn = np.asarray(k_new)
        assert np.all(kn >= cfg.min_k - 1e-9)
        assert np.all(kn <= cfg.k_max - cfg.ceiling_margin + 1e-9)
    # smooth_clip matches the reference formula (rlmpc2.py:611-614)
    x = rng.normal(size=34) * 2
    min_v, max_v, margin = cfg.min_k, cfg.k_max - cfg.ceiling_margin, 1e-3
    center = (max_v + min_v) / 2
    scale = (max_v - min_v) / 2 - margin
    want = center + scale * np.tanh((x - center) / scale)
    got = np.asarray(ppo_mod.smooth_clip(jnp.asarray(x), min_v, max_v))
    assert np.allclose(got, want, atol=1e-12)


def test_prox_reward_structure():
    cfg = ppo_mod.RewardConfig()
    at_target = float(ppo_mod.prox_reward(jnp.asarray(0.0), jnp.asarray(0.0), cfg))
    assert at_target == 90.0  # w_pos + w_vel
    far = float(ppo_mod.prox_reward(jnp.asarray(1.0), jnp.asarray(0.0), cfg))
    assert far < 1e-6


def test_actor_critic_shapes_and_logstd_clamp():
    model = ppo_mod.ActorCritic(act_dim=34)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros(520))
    mean, std, value = model.apply(params, jnp.zeros(520))
    assert mean.shape == (34,) and std.shape == (34,) and value.shape == ()
    assert np.allclose(np.asarray(std), 0.1, atol=1e-6)  # std_init
    # batched
    mean_b, _, value_b = model.apply(params, jnp.zeros((7, 520)))
    assert mean_b.shape == (7, 34) and value_b.shape == (7,)


def test_actor_critic_restores_committed_checkpoint():
    """The plain-JAX ActorCritic keeps the parameter tree of the Flax module
    that wrote `artifacts/lmpc/general/best_agent`, so it restores as is."""
    import os

    from dart_tpu.adapt import lmpc_trainer as trainer
    from dart_tpu.io import checkpoint as ckpt

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = ppo_mod.ActorCritic(act_dim=trainer.N_PARAMS)
    tx = ppo_mod.make_optimizer(ppo_mod.PPOConfig())
    ts = trainer.init_train_state(jax.random.PRNGKey(0), model, tx)
    restored = ckpt.load_agent(
        os.path.join(repo, "artifacts", "lmpc", "general"), "best_agent",
        template={"params": ts.params, "opt_state": ts.opt_state,
                  "episode": np.asarray(0), "return": np.asarray(0.0)})
    assert restored is not None
    assert (jax.tree.structure(restored["params"])
            == jax.tree.structure(ts.params))
    mean, std, value = model.apply(restored["params"],
                                   jnp.zeros(trainer.OBS_DIM))
    assert mean.shape == (trainer.N_PARAMS,) and value.shape == ()
    assert bool(jnp.all(jnp.isfinite(mean))) and bool(jnp.isfinite(value))
    # trained weights, not the init: the restored policy acts differently
    mean0, _, _ = model.apply(ts.params, jnp.zeros(trainer.OBS_DIM))
    assert float(jnp.max(jnp.abs(mean - mean0))) > 1e-3


def test_ppo_update_moves_policy_toward_advantage():
    """After an update, log-probabilities must shift in the advantage
    direction, and the value head must fit returns better."""
    rng = jax.random.PRNGKey(3)
    model = ppo_mod.ActorCritic(act_dim=4, hidden_size=32)
    obs_dim = 16
    params = model.init(rng, jnp.zeros(obs_dim))
    cfg = ppo_mod.PPOConfig(epochs=4, minibatch_size=32, lr=3e-4)
    tx = ppo_mod.make_optimizer(cfg)
    opt_state = tx.init(params)

    k1, k2, k3 = jax.random.split(rng, 3)
    T = 128
    obs = jax.random.normal(k1, (T, obs_dim))
    actions = jax.random.normal(k2, (T, 4)) * 0.1
    mean0, std0, _ = model.apply(params, obs)
    logps = ppo_mod.normal_logp(actions, mean0, std0)
    adv = jax.random.normal(k3, (T,))
    ret = jax.random.normal(k3, (T,))
    batch = ppo_mod.Batch(obs, actions, logps, adv, ret)

    new_params, _, _ = ppo_mod.ppo_update(params, opt_state, model, tx,
                                          batch, cfg, jax.random.PRNGKey(9))
    mean1, std1, value1 = model.apply(new_params, obs)
    logps1 = ppo_mod.normal_logp(actions, mean1, std1)
    advn = (adv - adv.mean()) / (adv.std() + 1e-8)
    corr = float(jnp.mean((logps1 - logps) * advn))
    assert corr > 0.0, corr
    # value head fits (normalised) returns better than the zero init
    retn = (ret - ret.mean()) / (ret.std() + 1e-8)
    _, _, value0 = model.apply(params, obs)
    assert float(jnp.mean((value1 - retn) ** 2)) < \
        float(jnp.mean((value0 - retn) ** 2))


def test_lmpc_train_step_smoke():
    """Tiny end-to-end: MPC-in-the-loop rollout + PPO update compiles & runs,
    parameters move, everything stays finite."""
    ctlr = mpc_mod.LMPC(N=8, dt=0.02,
                        cfg=mpc_mod.ilqr.ILQRConfig(max_iters=5))
    env_cfg = trainer.EnvConfig(dt=0.02, max_episode_steps=64)
    ppo_cfg = ppo_mod.PPOConfig(epochs=2, minibatch_size=8)
    model = ppo_mod.ActorCritic(act_dim=trainer.N_PARAMS)
    train_step, tx = trainer.make_train_step(model, ctlr, env_cfg, ppo_cfg,
                                             rollout_len=8)
    ts = trainer.init_train_state(jax.random.PRNGKey(0), model, tx)
    B = 2
    env_states = jax.vmap(
        lambda r: trainer.env_init(r, ctlr, env_cfg))(
            jax.random.split(jax.random.PRNGKey(1), B))

    jitted = jax.jit(train_step)
    ts2, env_states2, stats = jitted(ts, env_states)
    assert np.isfinite(float(stats["mean_reward"]))
    assert np.isfinite(float(stats["policy_loss"]))
    # policy params actually changed
    delta = jax.tree.reduce(
        lambda a, b: a + b,
        jax.tree.map(lambda a, b: float(jnp.abs(a - b).sum()),
                     ts.params, ts2.params))
    assert delta > 0.0
    # env advanced and stayed finite
    assert np.all(np.isfinite(np.asarray(env_states2.x)))


def test_replay_buffer_fill_and_flush():
    """Dual-buffer semantics (`rlmpc2.py:822-874`): 25% subsample per step,
    global pass exactly when the buffer fills (every 4 steps), then clear."""
    C, OD, AD = 16, 3, 2
    buf = ppo_mod.replay_init(C, OD, AD)
    rng = jax.random.PRNGKey(0)
    obs = jnp.arange(16.0 * OD).reshape(16, OD)
    acts = jnp.ones((16, AD))
    vec = jnp.arange(16.0)
    for i in range(3):
        buf = ppo_mod.replay_add_subsample(
            buf, obs, acts, vec, vec, vec, vec, jax.random.fold_in(rng, i))
        assert int(buf.size) == 4 * (i + 1)
    model = ppo_mod.ActorCritic(act_dim=AD, hidden_size=8, hidden_layers=1)
    params = model.init(jax.random.PRNGKey(1), jnp.zeros(OD))
    cfg = ppo_mod.PPOConfig(epochs=1, minibatch_size=8)
    tx = ppo_mod.make_optimizer(cfg)
    opt_state = tx.init(params)
    # not yet full -> no update, params unchanged
    p2, o2, buf2, did = ppo_mod.replay_maybe_update(
        params, opt_state, model, tx, buf, cfg, jax.random.PRNGKey(2))
    assert not bool(did) and int(buf2.size) == 12
    delta = jax.tree.reduce(
        lambda a, b: a + b,
        jax.tree.map(lambda a, b: float(jnp.abs(a - b).sum()), params, p2))
    assert delta == 0.0
    # fourth add fills it -> update fires and clears
    buf2 = ppo_mod.replay_add_subsample(
        buf2, obs, acts, vec, vec, vec, vec, jax.random.fold_in(rng, 3))
    assert int(buf2.size) == C
    p3, o3, buf3, did3 = ppo_mod.replay_maybe_update(
        params, opt_state, model, tx, buf2, cfg, jax.random.PRNGKey(3))
    assert bool(did3) and int(buf3.size) == 0
    delta3 = jax.tree.reduce(
        lambda a, b: a + b,
        jax.tree.map(lambda a, b: float(jnp.abs(a - b).sum()), params, p3))
    assert delta3 > 0.0


def test_lmpc_train_step_with_replay():
    """Trainer integration: replay=True signature carries the buffer; after
    4 steps the global update fires (stats['global_update'] == 1)."""
    ctlr = mpc_mod.LMPC(N=4, dt=0.02,
                        cfg=mpc_mod.ilqr.ILQRConfig(max_iters=2, al_iters=1))
    env_cfg = trainer.EnvConfig(dt=0.02, max_episode_steps=16)
    ppo_cfg = ppo_mod.PPOConfig(epochs=1, minibatch_size=4)
    model = ppo_mod.ActorCritic(act_dim=trainer.N_PARAMS, hidden_size=16,
                                hidden_layers=1)
    train_step, tx = trainer.make_train_step(model, ctlr, env_cfg, ppo_cfg,
                                             rollout_len=4, replay=True)
    ts = trainer.init_train_state(jax.random.PRNGKey(0), model, tx)
    B = 2
    env_states = jax.vmap(
        lambda r: trainer.env_init(r, ctlr, env_cfg))(
            jax.random.split(jax.random.PRNGKey(1), B))
    buf = trainer.init_replay(B, 4, dtype=env_states.x.dtype)
    jitted = jax.jit(train_step)
    fired = []
    for _ in range(4):
        ts, env_states, buf, stats = jitted(ts, env_states, buf)
        fired.append(float(stats["global_update"]))
    assert fired == [0.0, 0.0, 0.0, 1.0], fired
    assert int(buf.size) == 0
