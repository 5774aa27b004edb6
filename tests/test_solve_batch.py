import numpy as np
import jax
import jax.numpy as jnp

from dart_tpu.models import dynamics as dyn
from dart_tpu.solver import ilqr
from dart_tpu.solver.ocp import PMPCAux, make_pmpc_ocp


def test_solve_batch_matches_vmap_solve():
    """Batch-major control flow (per-lane reg/acceptance/convergence) must
    produce the same first controls as vmapping the per-instance solver."""
    B, N = 16, 12
    ocp = make_pmpc_ocp(dt=0.02, u_bound=0.6)
    cfg = ilqr.ILQRConfig(max_iters=20)
    rng = np.random.default_rng(0)
    mus = jnp.asarray(rng.uniform(0.05, 0.2, size=B))
    targets = jnp.asarray(rng.uniform(-0.1, 0.1, size=(B, 6)) *
                          np.array([1, 0, 1, 0, 0, 0]))
    z0 = jnp.asarray(rng.normal(size=(B, 6)) * 0.02)
    V0 = jnp.zeros((B, N, 2))

    params = dyn.PMPCParams(mu=mus, g=jnp.full(B, -9.81),
                            dt=jnp.full(B, 0.02))
    aux = PMPCAux(target=targets, Qp=jnp.full(B, 300.0),
                  Qv=jnp.full(B, 2.0), R=jnp.full(B, 0.2))

    batched = ilqr.solve_batch(ocp, cfg, params, aux, z0, V0)
    ref = jax.vmap(lambda p, a, z, v: ilqr.solve(ocp, cfg, p, a, z, v))(
        params, aux, z0, V0)

    # Both must reach (essentially) the same optimum.
    assert np.allclose(np.asarray(batched.cost), np.asarray(ref.cost),
                       rtol=1e-5, atol=1e-8)
    assert np.allclose(np.asarray(batched.V[:, 0]), np.asarray(ref.V[:, 0]),
                       atol=5e-5), np.abs(
        np.asarray(batched.V[:, 0]) - np.asarray(ref.V[:, 0])).max()


def test_pmpc_batch_controller_matches_per_instance():
    """PMPCBatch.solve (batch-major front-end) == PMPC.solve per lane."""
    from dart_tpu.control import mpc as mpc_mod
    B = 4
    rng = np.random.default_rng(1)
    cfg = ilqr.ILQRConfig(max_iters=10)
    bctlr = mpc_mod.PMPCBatch(N=10, dt=0.02, cfg=cfg)
    sctlr = mpc_mod.PMPC(N=10, dt=0.02, cfg=cfg)
    states = jnp.asarray(rng.normal(size=(B, 6)) * 0.02)
    targets = jnp.asarray(rng.uniform(-0.08, 0.08, size=(B, 6)) *
                          np.array([1, 0, 1, 0, 0, 0]))
    mus = jnp.asarray(rng.uniform(0.05, 0.2, size=B))
    params = dyn.PMPCParams(mu=mus, dt=0.02)
    weights = mpc_mod.PMPCWeights(Qp=jnp.full(B, 300.0),
                                  Qv=jnp.full(B, 2.0), R=jnp.full(B, 0.2))
    carry = bctlr.init_carry(B, jnp.float64)
    _, u_batch, _ = bctlr.solve(carry, states, targets, params, weights)
    for i in range(B):
        p_i = dyn.PMPCParams(mu=mus[i], dt=0.02)
        w_i = mpc_mod.PMPCWeights(Qp=weights.Qp[i], Qv=weights.Qv[i],
                                  R=weights.R[i])
        _, u_i, _ = sctlr.solve(sctlr.init_carry(jnp.float64), states[i],
                                targets[i], p_i, w_i)
        assert np.allclose(np.asarray(u_batch[i]), np.asarray(u_i),
                           atol=5e-5), i


def test_solve_batch_constrained_matches_vmap():
    """AL-constrained batch-major solve (RMPC du-formulation, n_con=4)."""
    from dart_tpu.control.reference import build_ref_traj
    from dart_tpu.solver.ocp import RMPCAux, make_rmpc_ocp_du
    B, N = 6, 10
    ocp = make_rmpc_ocp_du(dt=0.02, u_bound=0.4, du_bound=0.05, vmax=0.25)
    cfg = ilqr.ILQRConfig(max_iters=15, al_iters=3)
    rng = np.random.default_rng(2)
    thetas = jnp.asarray(rng.normal(size=(B, 14)) * 0.05)
    params = dyn.RMPCParams(theta=thetas, g=jnp.full(B, -9.81),
                            v_eps=jnp.full(B, 0.1))
    refs = jnp.stack([
        build_ref_traj(jnp.zeros(4), jnp.asarray(
            rng.uniform(-0.08, 0.08, 4) * np.array([1, 0, 1, 0])), N)
        for _ in range(B)])
    aux = RMPCAux(ref=refs, Qp=jnp.full(B, 100.0), Qv=jnp.full(B, 1.0),
                  Ru=jnp.full(B, 0.05), Rdu=jnp.full(B, 1.0))
    z0 = jnp.asarray(rng.normal(size=(B, 6)) * 0.02)
    V0 = jnp.zeros((B, N, 2))

    batched = ilqr.solve_batch(ocp, cfg, params, aux, z0, V0)
    ref = jax.vmap(lambda p, a, z, v: ilqr.solve(ocp, cfg, p, a, z, v))(
        params, aux, z0, V0)
    assert np.allclose(np.asarray(batched.cost), np.asarray(ref.cost),
                       rtol=1e-4, atol=1e-7)
    assert np.allclose(np.asarray(batched.V[:, 0]), np.asarray(ref.V[:, 0]),
                       atol=1e-4)
    assert float(batched.viol.max()) < 1e-5


def test_rmpc_batch_controller_matches_per_instance():
    from dart_tpu.control import mpc as mpc_mod
    B = 3
    rng = np.random.default_rng(4)
    cfg = ilqr.ILQRConfig(max_iters=15, al_iters=3)
    b = mpc_mod.RMPCBatch(N=10, dt=0.02, cfg=cfg)
    s = mpc_mod.RMPC(N=10, dt=0.02, cfg=cfg)
    states = jnp.asarray(rng.normal(size=(B, 4)) * 0.03)
    prev_states = states - jnp.asarray(rng.normal(size=(B, 4)) * 0.002)
    targets = jnp.asarray(rng.uniform(-0.08, 0.08, size=(B, 4)) *
                          np.array([1, 0, 1, 0]))
    carry_b = b.init_carry_batch(prev_states, jnp.float64)
    carry2_b, u_b, _ = b.solve_batched(carry_b, states, targets)
    for i in range(B):
        carry_i = s.init_carry(prev_states[i], jnp.float64)
        _, u_i, _ = s.solve(carry_i, states[i], targets[i])
        assert np.allclose(np.asarray(u_b[i]), np.asarray(u_i), atol=2e-4), \
            (i, np.asarray(u_b[i]), np.asarray(u_i))


def test_lmpc_batch_controller_matches_per_instance():
    """LMPCBatch.solve_batched (closed-form lin, batch-major) == LMPC.solve
    (generic autodiff lin, per-instance) — exercises both the batch
    machinery and the fast-linearisation parity on the 34-param model."""
    from dart_tpu.control import mpc as mpc_mod
    B = 3
    rng = np.random.default_rng(5)
    cfg = ilqr.ILQRConfig(max_iters=15)
    b = mpc_mod.LMPCBatch(N=10, dt=0.002, cfg=cfg, fast=True)
    s = mpc_mod.LMPC(N=10, dt=0.002, cfg=cfg, fast=False)
    states = jnp.asarray(rng.normal(size=(B, 8)) * 0.03)
    targets = jnp.asarray(rng.uniform(-0.08, 0.08, size=(B, 8)) *
                          np.array([1, 0, 1, 0, 0, 0, 0, 0]))
    pvecs = jnp.asarray(rng.uniform(0.05, 0.3, size=(B, 34)))
    carry_b = b.init_carry_batch(B, jnp.float64)
    carry2_b, u_b, _ = b.solve_batched(carry_b, states, targets, pvecs)
    for i in range(B):
        carry_i = s.init_carry(jnp.float64)
        carry2_i, u_i, _ = s.solve(carry_i, states[i], targets[i], pvecs[i])
        assert np.allclose(np.asarray(u_b[i]), np.asarray(u_i), atol=2e-4), \
            (i, np.asarray(u_b[i]), np.asarray(u_i))
        assert np.allclose(np.asarray(carry2_b.U_plan[i]),
                           np.asarray(carry2_i.U_plan), atol=5e-4)

    # Per-lane plan shifting agrees with the scalar version.
    carry3_b, u_shift_b = b.shift_plan_batched(carry2_b)
    for i in range(B):
        c_i = mpc_mod.LMPCCarry(V=carry2_b.V[i], U_plan=carry2_b.U_plan[i],
                                plan_idx=carry2_b.plan_idx[i],
                                u_prev=carry2_b.u_prev[i])
        _, u_i = s.shift_plan(c_i)
        assert np.allclose(np.asarray(u_shift_b[i]), np.asarray(u_i))


def test_pmpc_batch_fast_path_honors_custom_g():
    """The fast-XLA fallback must forward a non-default static params.g
    (ADVICE r2 medium: it was silently replaced by the default -9.81), and
    a batched/array params.g must route to the generic batch solver which
    honors it per lane."""
    from dart_tpu.control import mpc as mpc_mod
    B = 4
    rng = np.random.default_rng(7)
    cfg = ilqr.ILQRConfig(max_iters=10)
    sctlr = mpc_mod.PMPC(N=10, dt=0.02, cfg=cfg)
    states = jnp.asarray(rng.normal(size=(B, 6)) * 0.02)
    targets = jnp.asarray(rng.uniform(-0.08, 0.08, size=(B, 6)) *
                          np.array([1, 0, 1, 0, 0, 0]))
    mus = jnp.asarray(rng.uniform(0.05, 0.2, size=B))
    weights = mpc_mod.PMPCWeights(Qp=jnp.full(B, 300.0),
                                  Qv=jnp.full(B, 2.0), R=jnp.full(B, 0.2))
    g_custom = -9.81 * 5.0 / 7.0          # the rolling-sphere scaled g

    def per_instance(g_i):
        us = []
        for i in range(B):
            p_i = dyn.PMPCParams(mu=mus[i], dt=0.02, g=g_i)
            w_i = mpc_mod.PMPCWeights(Qp=weights.Qp[i], Qv=weights.Qv[i],
                                      R=weights.R[i])
            _, u_i, _ = sctlr.solve(sctlr.init_carry(jnp.float64),
                                    states[i], targets[i], p_i, w_i)
            us.append(np.asarray(u_i))
        return np.stack(us)

    ref = per_instance(g_custom)

    # static float g -> fast path (use_kernel irrelevant on CPU)
    bctlr = mpc_mod.PMPCBatch(N=10, dt=0.02, cfg=cfg)
    params = dyn.PMPCParams(mu=mus, dt=0.02, g=g_custom)
    _, u_fast, _ = bctlr.solve(bctlr.init_carry(B, jnp.float64), states,
                               targets, params, weights)
    assert np.allclose(np.asarray(u_fast), ref, atol=5e-5), \
        np.abs(np.asarray(u_fast) - ref).max()
    # and it must NOT equal the default-gravity answer
    assert not np.allclose(ref, per_instance(-9.81), atol=1e-4)

    # array g -> generic batch path, honored per lane
    params_arr = dyn.PMPCParams(mu=mus, dt=0.02, g=jnp.full(B, g_custom))
    _, u_arr, _ = bctlr.solve(bctlr.init_carry(B, jnp.float64), states,
                              targets, params_arr, weights)
    assert np.allclose(np.asarray(u_arr), ref, atol=5e-5)
