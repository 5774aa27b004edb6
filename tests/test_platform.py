"""The platform decision of `ops.route`, the compile-cache helper, and the
GPU-only entry points' refusal to run anywhere else."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dart_tpu.ops import route as route_mod
from dart_tpu.utils import cache as cache_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform, expected",
                         [("gpu", "triton"), ("cpu", None)])
def test_solve_route_follows_platform(monkeypatch, platform, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert route_mod.solve_route() == expected


def test_solve_route_rejects_other_platforms(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="metal"):
        route_mod.solve_route()


def test_forced_route_nests_and_restores():
    assert route_mod.solve_route() is None          # tests run on the CPU
    with route_mod.forced("xla"):
        assert route_mod.solve_route() == "xla"
        with route_mod.forced("interpret"):
            assert route_mod.solve_route() == "interpret"
        assert route_mod.solve_route() == "xla"
    assert route_mod.solve_route() is None
    with pytest.raises(ValueError):
        with route_mod.forced("reference"):
            pass


def test_pmpc_batch_takes_the_kernel_path_only_when_routed():
    """The CPU decision keeps the adaptive solver (no iteration count in the
    diag); a forced route runs the fixed-budget body with escalation, and
    both land on the same controls to solver tolerance."""
    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.models import dynamics as dyn

    B, N = 40, 8
    rng = np.random.default_rng(0)
    states = jnp.asarray(rng.normal(size=(B, 6)) * 0.02, jnp.float32)
    z = np.zeros(B)
    tgts = jnp.asarray(np.stack([rng.uniform(-0.08, 0.08, B), z,
                                 rng.uniform(-0.08, 0.08, B), z,
                                 np.full(B, 0.43), z], -1), jnp.float32)
    params = dyn.PMPCParams(mu=jnp.full((B,), 0.1, jnp.float32), dt=0.01)
    w = mpc_mod.PMPC_WEIGHTS["general"]
    ctlr = mpc_mod.PMPCBatch(N=N, dt=0.01)
    carry = ctlr.init_carry(B, jnp.float32)
    _, u_cpu, d_cpu = jax.jit(
        lambda c: ctlr.solve(c, states, tgts, params, w))(carry)
    with route_mod.forced("xla"):
        _, u_k, d_k = jax.jit(
            lambda c: ctlr.solve(c, states, tgts, params, w))(carry)
    assert int(jnp.max(d_cpu.iters)) == 0
    assert int(jnp.min(d_k.iters)) >= ctlr.kernel_iters
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_cpu),
                               atol=2e-3)


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(cache_mod.ENV, str(tmp_path))
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    assert cache_mod.enable_compile_cache() == str(tmp_path)
    assert seen == {"jax_compilation_cache_dir": str(tmp_path)}


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(cache_mod.ENV, raising=False)
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    path = os.path.join(REPO, ".jax_cache")
    assert cache_mod.enable_compile_cache() == path
    assert seen == {"jax_compilation_cache_dir": path}


def _run_on_cpu(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_fail_without_gpu(script):
    r = _run_on_cpu(os.path.join(REPO, script), REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "solves/s" not in r.stdout
    assert "GPU" in r.stderr


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_on_cpu(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
