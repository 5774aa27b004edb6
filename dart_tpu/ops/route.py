"""The one decision of which whole-solve path the batch controllers take.

`PMPCBatch`, `RMPCBatch` and `LMPCBatch` each have two algorithms: a
fixed-budget whole solve with self-escalation (the kernel path) and the
adaptive XLA solvers (`pmpc_fast.solve_batch_fast`, `ilqr.solve_batch`).
The platform picks between them, here and nowhere else:

- ``gpu``: the kernel path. PMPC runs its whole solve as the Triton kernel
  (`ops.pallas.pmpc_solve`); RMPC and LMPC run their fixed-budget bodies
  (`ops.rmpc_solve`, `ops.lmpc_solve`) as plain XLA.
- ``cpu``: the adaptive XLA solvers.
- anything else: an error.

Tests and parity checks that need the kernel path on the CPU force a route
with `forced`: ``"xla"`` runs the PMPC body under XLA, ``"interpret"`` runs
the Triton kernel in Pallas interpret mode. Nothing falls back on its own.
"""

from __future__ import annotations

import contextlib

import jax

ROUTES = ("triton", "xla", "interpret")
_forced: list[str] = []


def solve_route() -> str | None:
    """The PMPC whole-solve route for the current platform, or None for the
    adaptive XLA solvers (see module docstring)."""
    if _forced:
        return _forced[-1]
    platform = jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return None
    raise RuntimeError(f"no batch solve path for platform {platform!r}; "
                       "supported: gpu, cpu")


@contextlib.contextmanager
def forced(route: str):
    """Take `route` instead of the platform's choice while tracing inside
    this block (controllers read the decision when their solve is traced)."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; expected one of {ROUTES}")
    _forced.append(route)
    try:
        yield
    finally:
        _forced.pop()
