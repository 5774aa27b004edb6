"""Whole-solve PMPC body: parity with the adaptive structure-exploiting
solver at a matched iteration budget, the Triton kernel (Pallas interpret
mode on the CPU) against the same body under XLA, the wrapper's padding,
and the escalation loop of `PMPCBatch` on the kernel path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dart_tpu.ops import route as route_mod
from dart_tpu.ops.pallas.pmpc_solve import BLOCK, padded_size, pmpc_solve
from dart_tpu.solver import pmpc_fast
from dart_tpu.solver.ocp import PMPCAux

DT = 0.002


def test_whole_solve_kernel_matches_fast_solver():
    B, N = 128, 8   # small horizon: interpreter mode is slow
    rng = np.random.default_rng(0)
    mus = jnp.asarray(rng.uniform(0.05, 0.2, B), jnp.float32)
    tgts = jnp.asarray(rng.uniform(-0.1, 0.1, (B, 6)) *
                       np.array([1, 0, 1, 0, 0, 0]), jnp.float32)
    z0 = jnp.asarray(rng.normal(size=(B, 6)) * 0.02, jnp.float32)
    V0 = jnp.zeros((B, N, 2), jnp.float32)
    aux = PMPCAux(target=tgts, Qp=jnp.full(B, 300.0, jnp.float32),
                  Qv=jnp.full(B, 2.0, jnp.float32),
                  R=jnp.full(B, 0.2, jnp.float32))
    V_ref, _, cost_ref = pmpc_fast.solve_batch_fast(
        mus, aux, z0, V0, dt=DT, max_iters=1, n_alphas=2)

    Ad, Sd = pmpc_fast._affine_discretization(mus, -9.81, DT)
    wdiag = (np.asarray(aux.Qp)[:, None] * np.array([1, 0, 1, 0, 0, 0]) +
             np.asarray(aux.Qv)[:, None] * np.array([0, 1, 0, 1, 0, 0])
             ).astype(np.float32)
    tl = lambda x: jnp.moveaxis(jnp.asarray(x), 0, -1)
    V_p, cost_p, gnorm_p = pmpc_solve(
        tl(Ad), tl(Sd), tl(wdiag), aux.R, tl(tgts), tl(z0), tl(V0),
        dt=DT, n_iters=1, n_alphas=2, route="xla")
    V_p = jnp.moveaxis(V_p, -1, 0)

    # Same iteration budget, same problem: costs agree tightly and the
    # kernel never does worse than the XLA path.
    assert np.allclose(np.asarray(cost_p), np.asarray(cost_ref),
                       rtol=5e-3, atol=1e-4)
    d = np.abs(np.asarray(V_p[:, 0] - V_ref[:, 0]))
    assert np.percentile(d, 99) < 5e-3, np.percentile(d, 99)
    assert np.all(np.abs(np.asarray(V_p)) <= 0.6 + 1e-6)


def test_structure_guard_poisons_unstructured_inputs():
    """`pmpc_solve` reads only 7 free entries of the dense (6,6,L)
    Ad/Sd: production operators must pass the structure check
    with residual exactly 0, while a lane violating the implied sparsity
    (e.g. per-axis mu making Ad[0,1] != Ad[2,3]) must come back with its
    cost/gnorm certificates poisoned to +inf instead of a silent
    mis-solve."""
    from dart_tpu.ops.pallas.pmpc_solve import structure_residual

    B, N = 128, 8
    rng = np.random.default_rng(2)
    mus = jnp.asarray(rng.uniform(0.05, 0.2, B), jnp.float32)
    tgts = jnp.asarray(rng.uniform(-0.1, 0.1, (B, 6)) *
                       np.array([1, 0, 1, 0, 0, 0]), jnp.float32)
    z0 = jnp.asarray(rng.normal(size=(B, 6)) * 0.02, jnp.float32)
    V0 = jnp.zeros((B, N, 2), jnp.float32)
    aux = PMPCAux(target=tgts, Qp=jnp.full(B, 300.0, jnp.float32),
                  Qv=jnp.full(B, 2.0, jnp.float32),
                  R=jnp.full(B, 0.2, jnp.float32))
    Ad, Sd = pmpc_fast._affine_discretization(mus, -9.81, DT)
    tl = lambda x: jnp.moveaxis(jnp.asarray(x), 0, -1)
    # 1. production operators: residual is exactly zero on every lane
    resid = structure_residual(tl(Ad), tl(Sd), DT)
    assert float(jnp.max(resid)) == 0.0

    # 2. violate the structure on lane 0 only: cross-coupling entry the
    # kernel never reads
    Ad_bad = jnp.asarray(Ad).at[0, 0, 3].set(0.01)
    wdiag = (np.asarray(aux.Qp)[:, None] * np.array([1, 0, 1, 0, 0, 0]) +
             np.asarray(aux.Qv)[:, None] * np.array([0, 1, 0, 1, 0, 0])
             ).astype(np.float32)
    _, cost, gnorm = pmpc_solve(
        tl(Ad_bad), tl(Sd), tl(wdiag), aux.R, tl(tgts), tl(z0), tl(V0),
        dt=DT, n_iters=1, n_alphas=2, route="xla")
    assert not bool(jnp.isfinite(cost[0])), cost[0]
    assert not bool(jnp.isfinite(gnorm[0]))
    assert bool(jnp.all(jnp.isfinite(cost[1:])))   # clean lanes unaffected
    assert bool(jnp.all(jnp.isfinite(gnorm[1:])))


def test_kernel_escalation_recovers_starved_budget():
    """The anti-silent-divergence loop (PMPCBatch kernel path, the Triton
    kernel in interpret mode): a deliberately starved 1-iter x 1-alpha
    budget leaves lanes non-stationary (large projected-grad norm in the
    diag — visible, not a zeroed diag); with escalation enabled the same batch
    converges via warm kernel re-solves and the diag records the rounds."""
    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.models import dynamics as dyn

    B, N = 128, 8
    rng = np.random.default_rng(1)
    states = jnp.asarray(rng.normal(size=(B, 6)) * 0.05, jnp.float32)
    z = np.zeros(B)
    tgts = jnp.asarray(np.stack([rng.uniform(-0.12, 0.12, B), z,
                                 rng.uniform(-0.12, 0.12, B), z,
                                 np.full(B, 0.43), z], -1), jnp.float32)
    params = dyn.PMPCParams(mu=jnp.asarray(0.1), dt=0.01)
    w = mpc_mod.PMPC_WEIGHTS["general"]

    diag = {}
    for extra in (0, 3):
        ctlr = mpc_mod.PMPCBatch(N=N, dt=0.01, kernel_iters=1,
                                 kernel_alphas=1,
                                 kernel_max_extra_rounds=extra)
        carry = ctlr.init_carry(B, jnp.float32)
        with route_mod.forced("interpret"):
            _, _, d = jax.jit(
                lambda c: ctlr.solve(c, states, tgts, params, w))(carry)
        diag[extra] = d

    g0 = float(jnp.max(diag[0].grad_norm))
    g3 = float(jnp.max(diag[3].grad_norm))
    assert g0 > 0.05, g0                    # starved: visibly non-stationary
    # escalation recovers by >10x (the 1x1 budget caps at ~8e-3 after 3
    # rounds; default 2x3+escalation reaches below kernel_tol_grad)
    assert g3 < 0.01 and g3 < g0 / 10, (g0, g3)
    assert int(diag[3].iters[0]) > int(diag[0].iters[0])
    assert float(jnp.mean(diag[3].cost)) <= float(jnp.mean(diag[0].cost))


def test_kernel_escalation_rescues_nan_lane():
    """A lane whose warm start has diverged to NaN must be rescued by the
    escalation loop via a cold restart, not re-solved from the poisoned
    warm start forever (ADVICE r2): after escalation the NaN lane's control
    matches the clean solve of the same problem."""
    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.models import dynamics as dyn

    B, N = 128, 8
    rng = np.random.default_rng(3)
    states = jnp.asarray(rng.normal(size=(B, 6)) * 0.05, jnp.float32)
    z = np.zeros(B)
    tgts = jnp.asarray(np.stack([rng.uniform(-0.1, 0.1, B), z,
                                 rng.uniform(-0.1, 0.1, B), z,
                                 np.full(B, 0.43), z], -1), jnp.float32)
    params = dyn.PMPCParams(mu=jnp.asarray(0.1), dt=0.01)
    w = mpc_mod.PMPC_WEIGHTS["general"]
    ctlr = mpc_mod.PMPCBatch(N=N, dt=0.01, kernel_max_extra_rounds=2)

    clean = ctlr.init_carry(B, jnp.float32)
    poisoned = mpc_mod.PMPCCarry(
        V=clean.V.at[0].set(jnp.nan))

    with route_mod.forced("xla"):
        solve = jax.jit(lambda c: ctlr.solve(c, states, tgts, params, w))
        _, u_clean, _ = solve(clean)
        _, u_poisoned, d = solve(poisoned)

    assert bool(jnp.all(jnp.isfinite(u_poisoned)))
    # the rescued lane solves the same problem from the same (zero) start
    assert np.allclose(np.asarray(u_poisoned[0]), np.asarray(u_clean[0]),
                       atol=1e-5)
    # untouched lanes unaffected
    assert np.allclose(np.asarray(u_poisoned[1:]), np.asarray(u_clean[1:]),
                       atol=1e-5)


def _batch_last_problem(B, N, seed):
    """A PMPC batch in the whole-solve wrapper's batch-last layout."""
    rng = np.random.default_rng(seed)
    mus = jnp.asarray(rng.uniform(0.05, 0.2, B), jnp.float32)
    tgts = rng.uniform(-0.1, 0.1, (B, 6)) * np.array([1, 0, 1, 0, 0, 0])
    z0 = rng.normal(size=(B, 6)) * 0.02
    V0 = rng.uniform(-0.2, 0.2, (B, N, 2))
    wdiag = np.tile(np.array([300.0, 2, 300, 2, 0, 0]), (B, 1))
    Ad, Sd = pmpc_fast._affine_discretization(mus, -9.81, DT)
    tl = lambda x: jnp.moveaxis(jnp.asarray(x, jnp.float32), 0, -1)
    return (tl(Ad), tl(Sd), tl(wdiag), jnp.full((B,), 0.2, jnp.float32),
            tl(tgts), tl(z0), tl(V0))


@pytest.mark.parametrize("B", [100, 150])
def test_triton_kernel_interpret_matches_xla_body(B):
    """The Triton kernel (interpret mode) and the same body under XLA give
    the same solve at batches that are not a multiple of the block (two
    and three programs, the last one partly padding)."""
    args = _batch_last_problem(B, 5, seed=4)
    kw = dict(dt=DT, n_iters=2, n_alphas=2)
    V_x, c_x, g_x = pmpc_solve(*args, route="xla", **kw)
    V_t, c_t, g_t = pmpc_solve(*args, route="interpret", **kw)
    assert V_t.shape == (5, 2, B) and c_t.shape == g_t.shape == (B,)
    np.testing.assert_allclose(np.asarray(V_t), np.asarray(V_x), atol=1e-6)
    np.testing.assert_allclose(np.asarray(c_t), np.asarray(c_x), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g_t), np.asarray(g_x), atol=1e-6)


def test_wrapper_padding_keeps_lanes_independent():
    """Padding to the block multiple (copies of the last lane) and
    stripping it after leaves every real lane's answer as if solved alone."""
    assert BLOCK % 32 == 0                     # whole warps per program
    assert padded_size(100) == 2 * BLOCK
    assert padded_size(BLOCK) == BLOCK
    assert padded_size(1) == BLOCK
    args = _batch_last_problem(70, 4, seed=5)
    kw = dict(dt=DT, n_iters=1, n_alphas=2, route="interpret")
    V_all, c_all, _ = pmpc_solve(*args, **kw)
    head = [a[..., :33] for a in args]         # 33 lanes -> one block
    V_head, c_head, _ = pmpc_solve(*head, **kw)
    assert V_head.shape[-1] == 33
    np.testing.assert_allclose(np.asarray(V_head),
                               np.asarray(V_all[..., :33]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(c_head), np.asarray(c_all[:33]),
                               rtol=1e-6)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: the Triton kernel compiles only "
                    "for the card")
    return jax.devices()[0]


@pytest.mark.gpu
def test_triton_kernel_on_gpu_matches_xla_body(gpu):
    """The compiled Triton kernel agrees with the same body under XLA at
    the production width (B=4096, N=15, 2 iterations x 3 alphas)."""
    args = _batch_last_problem(4096, 15, seed=6)
    kw = dict(dt=DT, n_iters=2, n_alphas=3)
    with jax.default_matmul_precision("highest"):
        V_x, c_x, _ = pmpc_solve(*args, route="xla", **kw)
    V_t, c_t, _ = pmpc_solve(*args, route="triton", **kw)
    d = np.abs(np.asarray(V_t) - np.asarray(V_x))
    assert np.percentile(d, 99) < 1e-4 and d.max() < 5e-3
    np.testing.assert_allclose(np.asarray(c_t), np.asarray(c_x), rtol=1e-4)
