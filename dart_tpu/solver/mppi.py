"""MPPI (Model Predictive Path Integral) sampling solver.

A derivative-free alternative to the box-DDP solver for the same OCPs:
K perturbed control sequences roll out in parallel (`vmap` over the ensemble
axis — thousands of rollouts per solve batch into one program), costs are
exponentially weighted (softmin with temperature lambda), and the nominal
sequence updates toward the weighted average. Covers the reference-baseline
"MPPI-style rollout ensembles per solve" evaluation mode and is robust to
the stiff/non-smooth LMPC Stribeck dynamics where Newton-type methods need
care.

Receding-horizon warm start: shift the nominal sequence one stage.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dart_tpu.solver.ilqr import OCPDef


class MPPIConfig(NamedTuple):
    n_samples: int = 256
    temperature: float = 0.1      # lambda: softmin sharpness
    sigma: float = 0.05           # exploration std per control channel
    n_iters: int = 1              # importance-sampling refinements per solve


def _rollout_cost(ocp: OCPDef, params, aux, z0, U):
    def f(z, inp):
        k, u = inp
        c = ocp.stage_cost(z, u, k, aux)
        return ocp.step(z, u, params), c

    zT, cs = jax.lax.scan(f, z0, (jnp.arange(U.shape[0]), U))
    return jnp.sum(cs) + ocp.term_cost(zT, aux)


@functools.partial(jax.jit, static_argnames=("ocp", "cfg"))
def solve(ocp: OCPDef, cfg: MPPIConfig, params, aux, z0: jnp.ndarray,
          U_nominal: jnp.ndarray, key: jnp.ndarray):
    """One MPPI solve. Returns (U_new, expected_cost)."""
    N, nu = U_nominal.shape
    dtype = U_nominal.dtype
    u_lo = jnp.asarray(ocp.u_lo, dtype)
    u_hi = jnp.asarray(ocp.u_hi, dtype)

    def one_iter(carry, key_i):
        U = carry
        eps = cfg.sigma * jax.random.normal(
            key_i, (cfg.n_samples, N, nu), dtype)
        Us = jnp.clip(U[None] + eps, u_lo, u_hi)
        costs = jax.vmap(lambda Uk: _rollout_cost(ocp, params, aux, z0, Uk))(Us)
        beta = jnp.min(costs)
        w = jnp.exp(-(costs - beta) / cfg.temperature)
        w = w / jnp.sum(w)
        U_new = jnp.clip(jnp.einsum("k,knu->nu", w, Us), u_lo, u_hi)
        return U_new, jnp.sum(w * costs)

    keys = jax.random.split(key, cfg.n_iters)
    U, costs = jax.lax.scan(one_iter, U_nominal, keys)
    return U, costs[-1]


def shift(U: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([U[1:], U[-1:]], axis=0)


class MPPICarry(NamedTuple):
    U: jnp.ndarray
    key: jnp.ndarray


def make_controller(ocp: OCPDef, cfg: MPPIConfig, N: int):
    """Receding-horizon front-end compatible with the rollout engines:
    solve_fn(carry, params, aux, z0) -> (carry, u)."""

    def init_carry(key, dtype=jnp.float32):
        return MPPICarry(U=jnp.zeros((N, ocp_nu(ocp)), dtype), key=key)

    def step(carry: MPPICarry, params, aux, z0):
        key, sub = jax.random.split(carry.key)
        U, cost = solve(ocp, cfg, params, aux, z0, carry.U, sub)
        return MPPICarry(U=shift(U), key=key), U[0], cost

    return init_carry, step


def ocp_nu(ocp: OCPDef) -> int:
    return len(ocp.u_lo)
