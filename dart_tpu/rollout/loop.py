"""Jit-compiled closed-loop engine: the replacement for the reference's
real-time process orchestration.

One `lax.scan` step = {observe -> (solve | hold) -> apply -> plant step},
replacing the queue/shared-memory pipelines P1-P3 of SURVEY.md section 2.6
with pure dataflow. Asynchrony semantics of the reference are reproduced
*explicitly*:

- ``control_every`` emulates the MPC running slower than the plant
  (`PMPC/main_parallel.py:198-205` latest-wins drain);
- a custom ``hold_fn`` (e.g. `LMPC.shift_plan`) emulates plan-shifting under
  solver lag (`rlmpc2.py:1013-1018`);
- ``warmup_steps`` emulates the settling/stabilisation phases
  (`main_parallel.py:158-168, 208`).

The default synchronous mode (solve every step, no lag) is the "better" mode
the reference could not afford on CPU.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from dart_tpu.control.mpc import SolveDiag


class ClosedLoopResult(NamedTuple):
    X: jnp.ndarray          # (T+1, nx_plant) plant states
    U: jnp.ndarray          # (T, nu) applied controls
    diag: SolveDiag         # per-step diagnostics (zeros on hold steps)
    carry: Any              # final controller carry


def _zero_diag(dtype) -> SolveDiag:
    z = jnp.zeros((), dtype)
    return SolveDiag(z, z, jnp.zeros((), jnp.int32), z)


@partial(jax.jit, static_argnames=("solve_fn", "hold_fn", "plant_step",
                                   "observe", "n_steps", "control_every",
                                   "warmup_steps"))
def run_closed_loop(
    solve_fn: Callable,                  # (carry, obs, target) -> (carry, u, diag)
    plant_step: Callable,                # (x, u, plant_params) -> x_next
    carry0: Any,
    x0: jnp.ndarray,
    target: jnp.ndarray,
    plant_params: Any,
    n_steps: int,
    observe: Callable = lambda x: x,
    control_every: int = 1,
    warmup_steps: int = 0,
    hold_fn: Optional[Callable] = None,  # (carry, obs, target) -> (carry, u, diag)
) -> ClosedLoopResult:
    dtype = x0.dtype
    nu = 2

    def default_hold(carry, obs, target, u_held):
        return carry, u_held, _zero_diag(dtype)

    def step(sc, k):
        ctrl_carry, x, u_held = sc
        obs = observe(x)
        do_solve = (k >= warmup_steps) & ((k - warmup_steps) % control_every == 0)

        def branch_solve(c):
            return solve_fn(c, obs, target)

        def branch_hold(c):
            if hold_fn is None:
                return default_hold(c, obs, target, u_held)
            nc, u, d = hold_fn(c, obs, target)
            return nc, u, d

        ctrl_carry, u, diag = jax.lax.cond(do_solve, branch_solve, branch_hold,
                                           ctrl_carry)
        u = jnp.where(k >= warmup_steps, u, jnp.zeros_like(u))
        x_next = plant_step(x, u, plant_params)
        return (ctrl_carry, x_next, u), (x_next, u, diag)

    init = (carry0, x0, jnp.zeros(nu, dtype))
    (carry, _, _), (Xs, U, diag) = jax.lax.scan(step, init,
                                                jnp.arange(n_steps))
    X = jnp.concatenate([x0[None], Xs], axis=0)
    return ClosedLoopResult(X=X, U=U, diag=diag, carry=carry)
