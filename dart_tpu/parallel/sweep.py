"""Device-mesh scenario sweeps: the framework's distributed backend.

Where the reference's "distributed backend" is one host's worth of
processes and shared memory (SURVEY.md section 2.6), here a scenario batch
(18-config grid x targets x ensembles) shards over a `jax.sharding.Mesh`
axis; each device runs its shard of closed-loop episodes under `vmap`, and
aggregate statistics reduce with `psum` over the interconnect. Multi-host
extends the same mesh via `jax.distributed.initialize` — no code change.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from dart_tpu.io.scenes import ScenarioBatch, pad_to_multiple
from dart_tpu.ops.pallas.pmpc_solve import BLOCK


def make_mesh(n_devices: int | None = None, axis: str = "scenario") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


class SweepAggregate(NamedTuple):
    n: jnp.ndarray
    n_converged: jnp.ndarray
    mean_sse: jnp.ndarray          # mean steady-state error
    mean_effort: jnp.ndarray
    mean_conv_time: jnp.ndarray    # over converged episodes only


def run_sweep(evaluate: Callable, batch: ScenarioBatch, mesh: Mesh,
              axis: str = "scenario"):
    """Shard `batch` over the mesh, run vmapped episodes per device, and
    psum-reduce the aggregate. Returns (per-scenario Metrics, SweepAggregate)
    with padding rows removed.

    `evaluate(kappa_inv, mass, mu, target_xy) -> PMPCScenarioResult`.
    """
    return _run(lambda s: jax.vmap(lambda k, m, mu, t: evaluate(k, m, mu, t))(
        s.kappa_inv, s.mass, s.mu, s.target_xy), batch, mesh, axis, 1)


def run_sweep_batched(evaluate_batch: Callable, batch: ScenarioBatch,
                      mesh: Mesh, axis: str = "scenario",
                      lane_multiple: int = BLOCK):
    """Batch-major sweep: each device runs its WHOLE scenario shard through
    one batched evaluator call (e.g. `make_rmpc_batch_evaluator`) instead of
    vmapped per-scenario episodes. Shards are padded to `lane_multiple`
    scenarios — by default one Triton block of the PMPC whole-solve kernel,
    so its wrapper adds no padding of its own; the mesh axis stays pure
    data parallelism with a psum only at the aggregate.

    `evaluate_batch(kappa_inv (B,2), mass (B,), mu (B,), target_xy (B,2))
    -> PMPCScenarioResult` with per-lane metrics.
    """
    return _run(lambda s: evaluate_batch(s.kappa_inv, s.mass, s.mu,
                                         s.target_xy),
                batch, mesh, axis, lane_multiple)


def sweep_hlo(evaluate: Callable, batch: ScenarioBatch, mesh: Mesh,
              axis: str = "scenario") -> str:
    """Optimized HLO text of the compiled sharded sweep program — for the
    collective census (`tools/bench_scaling.py`): the scenario axis is
    pure data parallelism, so the ONLY collectives in the whole program
    must be the final metric-aggregate psums, independent of device
    count. This turns the scaling claim ("collective-free episode body")
    into a measured property of the compiled program rather than an
    assertion — the honest substitute for multi-chip wall-clock scaling
    on a host with one reachable chip."""
    sharded, padded, valid = _build(
        lambda s: jax.vmap(lambda k, m, mu, t: evaluate(k, m, mu, t))(
            s.kappa_inv, s.mass, s.mu, s.target_xy), batch, mesh, axis, 1)
    return jax.jit(sharded).lower(padded, valid).compile().as_text()


def _build(eval_shard: Callable, batch: ScenarioBatch, mesh: Mesh,
           axis: str, lane_multiple: int):
    n_dev = mesh.devices.size
    padded, n_real = pad_to_multiple(batch, n_dev * lane_multiple)
    valid = (jnp.arange(padded.size) < n_real).astype(batch.mass.dtype)

    def shard_fn(shard: ScenarioBatch, valid: jnp.ndarray):
        res = eval_shard(shard)
        m = res.metrics
        conv = m.converged.astype(valid.dtype) * valid
        agg = SweepAggregate(
            n=jax.lax.psum(jnp.sum(valid), axis),
            n_converged=jax.lax.psum(jnp.sum(conv), axis),
            mean_sse=jax.lax.psum(jnp.sum(m.steady_state_error * valid), axis),
            mean_effort=jax.lax.psum(jnp.sum(m.control_effort * valid), axis),
            mean_conv_time=jax.lax.psum(
                jnp.sum(jnp.where(conv > 0, m.convergence_time, 0.0)), axis),
        )
        return res, agg

    sharded = jax.shard_map(shard_fn, mesh=mesh,
                            in_specs=(P(axis), P(axis)),
                            out_specs=(P(axis), P()),
                            check_vma=False)
    return sharded, padded, valid


def _run(eval_shard: Callable, batch: ScenarioBatch, mesh: Mesh,
         axis: str, lane_multiple: int):
    n_dev = mesh.devices.size
    _, n_real = pad_to_multiple(batch, n_dev * lane_multiple)
    sharded, padded, valid = _build(eval_shard, batch, mesh, axis,
                                    lane_multiple)
    res, agg = jax.jit(sharded)(padded, valid)
    trim = jax.tree.map(lambda x: x[:n_real], res)
    n_conv = jnp.maximum(agg.n_converged, 1.0)
    agg = SweepAggregate(
        n=agg.n,
        n_converged=agg.n_converged,
        mean_sse=agg.mean_sse / agg.n,
        mean_effort=agg.mean_effort / agg.n,
        mean_conv_time=agg.mean_conv_time / n_conv,
    )
    return trim, agg
