"""Batch-major RMPC closed-loop evaluator == vmapped per-instance evaluator
(adaptive XLA path on the CPU; the fixed-budget body of the GPU path is
covered by test_rmpc_solve_kernel and test_rmpc_kernel_rescue)."""

import numpy as np
import jax
import jax.numpy as jnp

from dart_tpu.rollout.evaluate import (make_pmpc_batch_evaluator,
                                       make_pmpc_evaluator,
                                       make_rmpc_batch_evaluator,
                                       make_rmpc_evaluator)


def test_rmpc_batch_evaluator_matches_per_instance():
    B = 4
    kw = dict(n_steps=300, dt=0.002, control_every=5, warmup_steps=50,
              N=8, max_iters=6, tol=0.01)
    ev_b = make_rmpc_batch_evaluator(**kw, use_kernel=False)
    ev_s = make_rmpc_evaluator(**kw)

    kappa = jnp.asarray([[0.0, 0.0], [2.0, 0.0], [2.5, 2.5], [0.0, 0.0]],
                        jnp.float32)
    mass = jnp.asarray([1.0, 2.0, 1.0, 2.0], jnp.float32)
    mu = jnp.asarray([0.1, 0.05, 0.2, 0.1], jnp.float32)
    targ = jnp.asarray([[0.05, -0.03], [-0.04, 0.02], [0.03, 0.05],
                        [-0.05, -0.05]], jnp.float32)

    rb = jax.jit(ev_b)(kappa, mass, mu, targ)
    rs = jax.jit(jax.vmap(ev_s))(kappa, mass, mu, targ)

    # Same per-lane final positions and metrics (identical math, batch-major
    # vs vmapped layouts; tolerance covers solver tie-breaking noise).
    assert np.allclose(np.asarray(rb.final_p), np.asarray(rs.final_p),
                       atol=2e-3), (rb.final_p, rs.final_p)
    assert np.array_equal(np.asarray(rb.metrics.converged),
                          np.asarray(rs.metrics.converged))
    assert np.allclose(np.asarray(rb.metrics.steady_state_error),
                       np.asarray(rs.metrics.steady_state_error), atol=2e-3)
    assert np.allclose(np.asarray(rb.metrics.control_effort),
                       np.asarray(rs.metrics.control_effort), rtol=0.05,
                       atol=1e-3)


def test_pmpc_batch_evaluator_matches_per_instance():
    B = 4
    kw = dict(n_steps=300, dt=0.002, control_every=5, warmup_steps=50,
              N=8, max_iters=4, tol=0.01)
    ev_b = make_pmpc_batch_evaluator(**kw, use_kernel=False)
    ev_s = make_pmpc_evaluator(**kw)

    kappa = jnp.asarray([[0.0, 0.0], [2.0, 0.0], [2.5, 2.5], [0.0, 0.0]],
                        jnp.float32)
    mass = jnp.asarray([1.0, 2.0, 1.0, 2.0], jnp.float32)
    mu = jnp.asarray([0.1, 0.05, 0.2, 0.1], jnp.float32)
    targ = jnp.asarray([[0.05, -0.03], [-0.04, 0.02], [0.03, 0.05],
                        [-0.05, -0.05]], jnp.float32)

    rb = jax.jit(ev_b)(kappa, mass, mu, targ)
    rs = jax.jit(jax.vmap(ev_s))(kappa, mass, mu, targ)

    # PMPCBatch(fast) vs per-instance generic solver: same math to solver
    # tie-breaking; closed-loop trajectories should stay close over 300
    # steps on these gentle scenarios.
    assert np.allclose(np.asarray(rb.final_p), np.asarray(rs.final_p),
                       atol=5e-3), (rb.final_p, rs.final_p)
    assert np.allclose(np.asarray(rb.metrics.steady_state_error),
                       np.asarray(rs.metrics.steady_state_error), atol=5e-3)
