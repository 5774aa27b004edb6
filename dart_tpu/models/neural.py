"""Learned neural transition models for MPC (gradient-through-network).

The baseline's LMPC evaluation mode describes "PPO-learned dynamics MLP as
MPC transition model, gradient-through-network rollouts" (BASELINE.json
configs). The reference realises the learned model as a 34-parameter
parametric family (`rlmpc2.py:260-429`, see `models/dynamics.lmpc_dynamics`);
this module adds the *network* form of the same capability: an MLP
transition model whose Jacobians flow through `jax.jacfwd` inside the
box-DDP solver — CasADi could not differentiate a torch network, JAX does
it natively.

Pieces:
- `DynamicsMLP`: tanh MLP xdot-predictor with an optional analytic prior
  (residual learning: xdot = prior(x, u) + MLP(x, u)).
- `make_neural_ocp`: an `OCPDef` whose dynamics are the trained network
  (params are the OCP's traced parameters -> online-updatable).
- `fit_dynamics`: supervised regression on (x, u, xdot) transitions
  collected from any plant, one jitted Adam loop.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from dart_tpu.adapt.ppo import dense, dense_init
from dart_tpu.models import dynamics as dyn
from dart_tpu.solver.ilqr import OCPDef


@dataclasses.dataclass(frozen=True)
class DynamicsMLP:
    """xdot = MLP([x, u]) (the prior, if any, is added by `neural_xdot`).
    State/control dims are inferred at `init`; layers are {"params":
    {"Dense_0": {"kernel", "bias"}, ...}} with LeCun-normal kernels."""

    nx: int
    hidden: Sequence[int] = (64, 64)

    def init(self, rng, x: jnp.ndarray, u: jnp.ndarray):
        dims = [x.shape[-1] + u.shape[-1], *self.hidden, self.nx]
        keys = jax.random.split(rng, len(dims) - 1)
        init = jax.nn.initializers.lecun_normal()
        return {"params": {f"Dense_{i}": dense_init(k, dims[i], dims[i + 1],
                                                    init)
                           for i, k in enumerate(keys)}}

    def apply(self, params, x: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        p = params["params"]
        h = jnp.concatenate([x, u], axis=-1)
        for i in range(len(self.hidden)):
            h = jnp.tanh(dense(p[f"Dense_{i}"], h))
        return dense(p[f"Dense_{len(self.hidden)}"], h)


class NeuralModel(NamedTuple):
    module: DynamicsMLP
    prior: Optional[Callable] = None      # (x, u) -> xdot analytic part


def neural_xdot(nm: NeuralModel, params, x, u):
    out = nm.module.apply(params, x, u)
    if nm.prior is not None:
        out = out + nm.prior(x, u)
    return out


def make_neural_ocp(nm: NeuralModel, dt: float, nx: int,
                    u_bound: float = 0.4,
                    Q=None, R=None, Qt=None) -> OCPDef:
    """OCP over the learned dynamics; per-solve `params` = network weights.

    Cost layout mirrors the LMPC stage cost (diag Q state error + diag R on
    [u, du] with u_prev augmentation), aux = (target, Q, R, Qt) like
    `solver.ocp.LMPCAux`.
    """

    def xdot(x, u, params):
        return neural_xdot(nm, params, x, u)

    step_x = dyn.discretize(xdot, dt)

    def step(z, v, params):
        xn = step_x(z[:nx], v, params)
        return jnp.concatenate([xn, v])

    def stage_cost(z, v, k, aux):
        target, Qd, Rd, _ = aux
        e = z[:nx] - target
        du = v - z[nx:nx + 2]
        ctrl = jnp.concatenate([v, du])
        return jnp.sum(Qd * e * e) + jnp.sum(Rd * ctrl * ctrl)

    def term_cost(z, aux):
        target, _, _, Qtd = aux
        e = z[:nx] - target
        return jnp.sum(Qtd * e * e)

    return OCPDef(step=step, stage_cost=stage_cost, term_cost=term_cost,
                  u_lo=(-u_bound, -u_bound), u_hi=(u_bound, u_bound))


@partial(jax.jit, static_argnames=("nm", "steps", "batch"))
def fit_dynamics(nm: NeuralModel, params, X, U, Xdot, rng,
                 steps: int = 2000, lr: float = 1e-3, batch: int = 256):
    """Adam regression of xdot targets; returns (params, final_mse)."""
    n = X.shape[0]
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    def loss_fn(p, xb, ub, yb):
        pred = jax.vmap(lambda x, u: neural_xdot(nm, p, x, u))(xb, ub)
        return jnp.mean((pred - yb) ** 2)

    def body(carry, key):
        params, opt_state = carry
        idx = jax.random.randint(key, (batch,), 0, n)
        l, g = jax.value_and_grad(loss_fn)(params, X[idx], U[idx], Xdot[idx])
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), l

    keys = jax.random.split(rng, steps)
    (params, _), losses = jax.lax.scan(body, (params, opt_state), keys)
    return params, losses[-1]


def collect_transitions(plant_xdot: Callable, rng: np.random.Generator,
                        n: int, nx: int, x_scale=0.2, u_scale=0.4):
    """Random-state transition dataset from any analytic plant."""
    X = jnp.asarray(rng.normal(size=(n, nx)) * x_scale, jnp.float32)
    U = jnp.asarray(rng.uniform(-u_scale, u_scale, size=(n, 2)), jnp.float32)
    Xdot = jax.vmap(plant_xdot)(X, U)
    return X, U, Xdot
