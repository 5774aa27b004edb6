"""Smoke test of the batched PMPC closed loop on NVIDIA GPUs.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --multichip   # four GPUs: the sharded paths only

Phases (one GPU):
  device         platform, device kind, JAX version, XLA_FLAGS, compile
                 cache, and the card's name and power limit from nvidia-smi;
  pmpc_parity    the GPU whole solve (B=4096, N=15, 2 iterations x 3
                 alphas) against the same body under XLA at matmul
                 precision "highest" on the GPU, and its first 512 lanes
                 against the CPU; structure residual and escalation rounds;
  tf32           default against "highest" matmul precision for the setup
                 code that contracts in float32 (operators, XLA solver,
                 arm chain dynamics, arm QP);
  closed_loop    `PMPCBatch.solve` (escalation included) in the bench's
                 closed loop, B=4096 for 1200 steps, quality, and per-lane
                 agreement with the CPU on 256 lanes after 300 steps (the
                 CPU runs in a background thread meanwhile); the pmpc and
                 batch-major rmpc sweep CLIs; one MPC-in-the-loop PPO
                 update;
  kernel_vs_xla  per closed-loop step time of the Triton kernel and of the
                 same body under XLA at B=4096 and B=128 (plus the adaptive
                 `solve_batch_fast` for reference).

Phases (--multichip): `__graft_entry__.dryrun_multichip(4)` and the
batch-major PMPC sweep sharded over 4 GPUs against 1.

Exits nonzero, printing no result line, when JAX finds no GPU, when run
outside the repository, or when any phase fails. The last line of stdout
is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import contextlib
import inspect
import io
import json
import os
import subprocess
import sys
import threading
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
DT = 0.002
N = 15
# Sizes of each phase; small values are only for rehearsing the script on
# the CPU (the checks themselves refuse to run there).
SIZES = {"B": 4096, "cpu_lanes": 512, "loop_lanes_cpu": 256,
         "loop_steps": 1200, "loop_steps_cpu": 300, "time_steps": 300,
         "time_reps": 5,
         "time_batches": (4096, 128), "cli_runtime": "2",
         "sweep_steps": 1000}


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(*a):
    print(*a, flush=True)


def pmpc_problem(B, seed=0):
    """A PMPC batch: tray-frame targets within 10 cm, perturbed states, a
    random warm start, per-lane friction."""
    import jax.numpy as jnp
    import numpy as np

    from dart_tpu.solver.ocp import PMPCAux

    rng = np.random.default_rng(seed)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    mus = f32(rng.uniform(0.05, 0.2, B))
    targets = f32(rng.uniform(-0.1, 0.1, (B, 6)) * [1, 0, 1, 0, 0, 0])
    z0 = f32(rng.normal(size=(B, 6)) * 0.02)
    V0 = f32(rng.uniform(-0.3, 0.3, (B, N, 2)))
    aux = PMPCAux(target=targets, Qp=f32(np.full(B, 300.0)),
                  Qv=f32(np.full(B, 2.0)), R=f32(np.full(B, 0.2)))
    return mus, aux, z0, V0


def compare(label, V_a, c_a, V_b, c_b):
    """The parity bounds: cost rtol 1e-4 (atol 1e-6 for near-zero costs),
    99th percentile |dV| < 1e-4 rad, max |dV| < 5e-3 rad (a near-tie in
    line-search acceptance may flip a lane; flipped lanes are counted)."""
    import numpy as np

    V_a, V_b = np.asarray(V_a), np.asarray(V_b)
    c_a, c_b = np.asarray(c_a), np.asarray(c_b)
    dV = np.abs(V_a - V_b)
    lane = dV.reshape(dV.shape[0], -1).max(axis=1)
    rel = np.abs(c_a - c_b) / np.maximum(np.abs(c_b), 1e-2)
    stats = {"p99_dV": float(np.percentile(dV, 99)), "max_dV": float(dV.max()),
             "flipped_lanes": int(np.sum(lane > 1e-4)),
             "max_cost_rel": float(rel.max())}
    log(f"  {label}: {json.dumps(stats)}")
    check(np.all(np.isfinite(V_a)) and np.all(np.isfinite(c_a)),
          f"{label}: non-finite solve")
    check(np.allclose(c_a, c_b, rtol=1e-4, atol=1e-6), f"{label}: cost")
    check(stats["p99_dV"] < 1e-4, f"{label}: p99 |dV|")
    check(stats["max_dV"] < 5e-3, f"{label}: max |dV|")


def phase_device(devs, want):
    import jax

    from dart_tpu.utils.cache import cache_dir

    d = devs[0]
    log(f"  platform={d.platform} kind={d.device_kind} count={len(devs)} "
        f"jax={jax.__version__}")
    log(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={cache_dir()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        log(f"  nvidia-smi: {line.strip()}")
    check(d.platform == "gpu" and len(devs) >= want,
          f"need {want} GPU(s), found {len(devs)} {d.platform}")


def phase_pmpc_parity():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.models import dynamics as dyn
    from dart_tpu.ops import route as route_mod
    from dart_tpu.ops.pallas.pmpc_solve import structure_residual
    from dart_tpu.solver import pmpc_fast

    B = SIZES["B"]
    mus, aux, z0, V0 = pmpc_problem(B)
    route = route_mod.solve_route()
    kw = dict(dt=DT, n_iters=2, n_alphas=3)
    V_g, c_g, _ = pmpc_fast.solve_batch_kernel(mus, aux, z0, V0, route=route,
                                               **kw)
    with jax.default_matmul_precision("highest"):
        V_x, c_x, _ = pmpc_fast.solve_batch_kernel(mus, aux, z0, V0,
                                                   route="xla", **kw)
    compare(f"{route} vs xla@highest (B={B})", V_g, c_g, V_x, c_x)

    n = SIZES["cpu_lanes"]
    cpu = jax.devices("cpu")[0]
    sub = jax.device_put(jax.tree.map(lambda x: x[:n], (mus, aux, z0, V0)),
                         cpu)
    with jax.default_device(cpu):
        V_c, c_c, _ = pmpc_fast.solve_batch_kernel(*sub, route="xla", **kw)
    compare(f"{route} vs cpu xla (first {n} lanes)", V_g[:n], c_g[:n],
            V_c, c_c)

    with jax.default_matmul_precision("highest"):
        Ad, Sd = pmpc_fast._affine_discretization(mus, jnp.float32(-9.81),
                                                  DT)
    tl = lambda x: jnp.moveaxis(x, 0, -1)
    resid = float(jnp.max(structure_residual(tl(Ad), tl(Sd), DT)))
    log(f"  structure_residual={resid}")
    check(resid == 0.0, "structure residual is not exactly 0")

    ctlr = mpc_mod.PMPCBatch(N=N, dt=DT)
    _, u, d = jax.jit(lambda c: ctlr.solve(
        c, z0, aux.target, dyn.PMPCParams(mu=mus, dt=DT),
        mpc_mod.PMPC_WEIGHTS["general"]))(mpc_mod.PMPCCarry(V=V0))
    rounds = int(d.iters[0]) // ctlr.kernel_iters - 1
    log(f"  escalation_rounds={rounds} max_gnorm="
        f"{float(jnp.max(d.grad_norm))}")
    check(bool(jnp.all(jnp.isfinite(u))), "PMPCBatch.solve: non-finite u")


def phase_tf32():
    """Float32 contractions may run in TF32 on the card: compare default
    and "highest" matmul precision where the setup code contracts."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dart_tpu.ops import qp as qp_mod
    from dart_tpu.physics import chain
    from dart_tpu.solver import pmpc_fast

    mus, aux, z0, V0 = pmpc_problem(512, seed=1)
    rng = np.random.default_rng(1)
    params = chain.make_xarm7_chain()
    q = jnp.asarray(rng.uniform(-1, 1, (256, 7)), jnp.float32)
    qd = jnp.asarray(rng.normal(size=(256, 7)), jnp.float32)
    tau = jnp.asarray(rng.normal(size=(256, 7)) * 5, jnp.float32)
    n, m = 14, 20
    Pq = rng.normal(size=(64, n, n))
    P = jnp.asarray(Pq @ np.swapaxes(Pq, 1, 2) + n * np.eye(n), jnp.float32)
    qv = jnp.asarray(rng.normal(size=(64, n)), jnp.float32)
    A = jnp.asarray(rng.normal(size=(64, m, n)), jnp.float32)
    lo = jnp.full((64, m), -1.0, jnp.float32)

    from dart_tpu.models import dynamics as dyn
    from dart_tpu.solver import ilqr
    from dart_tpu.solver.ocp import make_pmpc_ocp

    sites = {
        "ilqr.solve_batch": lambda: ilqr.solve_batch(
            make_pmpc_ocp(dt=DT), ilqr.ILQRConfig(max_iters=4),
            dyn.PMPCParams(mu=mus, dt=jnp.full_like(mus, DT)), aux, z0,
            V0).V,
        "affine_discretization": lambda: pmpc_fast._affine_discretization(
            mus, jnp.float32(-9.81), DT),
        "solve_batch_fast": lambda: pmpc_fast.solve_batch_fast(
            mus, aux, z0, V0, dt=DT, max_iters=4)[0],
        "chain.forward_dynamics": lambda: jax.vmap(
            lambda a, b, c: chain.forward_dynamics(params, a, b, c))(
                q, qd, tau),
        "qp.solve_qp_admm": lambda: jax.vmap(
            lambda p_, q_, a_, l_: qp_mod.solve_qp_admm(
                p_, q_, a_, l_, -l_).x)(P, qv, A, lo),
    }
    for name, fn in sites.items():
        out_d = jax.tree.leaves(jax.jit(fn)())
        with jax.default_matmul_precision("highest"):
            out_h = jax.tree.leaves(jax.jit(fn)())
        rel = max(float(jnp.max(jnp.abs(a - b)) / (jnp.max(jnp.abs(b))
                                                   + 1e-30))
                  for a, b in zip(out_d, out_h))
        log(f"  tf32 {name}: max |default - highest| / max|highest| = "
            f"{rel:.3e}")
        check(np.isfinite(rel), f"{name}: non-finite")


def closed_loop_fn(ctlr, mus, targets, n_steps, track=0):
    """The bench's closed loop: `PMPCBatch.solve` + analytic plant step.
    Returns the final state and plan, and the (x, y) position of the first
    `track` lanes after every step."""
    import jax
    import jax.numpy as jnp

    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.models import dynamics as dyn

    plant = dyn.discretize(dyn.pmpc_dynamics, DT)
    prm = dyn.PMPCParams(mu=mus, dt=DT)
    wts = mpc_mod.PMPC_WEIGHTS["general"]

    @jax.jit
    def loop(x0, V0):
        def f(c, _):
            x, V = c
            c2, u, _ = ctlr.solve(mpc_mod.PMPCCarry(V=V), x, targets, prm,
                                  wts)
            x = jax.vmap(lambda x_, u_, m_: plant(
                x_, u_, dyn.PMPCParams(mu=m_, dt=DT)))(x, u, mus)
            return (x, c2.V), x[:track][:, jnp.array([0, 2])]

        (xf, Vf), pos = jax.lax.scan(f, (x0, V0), None, length=n_steps)
        return xf, Vf, pos

    return loop


def phase_closed_loop():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dart_tpu.adapt import lmpc_trainer as trainer
    from dart_tpu.adapt import ppo as ppo_mod
    from dart_tpu.cli import pmpc as cli_pmpc
    from dart_tpu.cli import sweep as cli_sweep
    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.ops import route as route_mod

    B, T = SIZES["B"], SIZES["loop_steps"]
    n, Tc = SIZES["loop_lanes_cpu"], SIZES["loop_steps_cpu"]
    mus, aux, _, _ = pmpc_problem(B, seed=2)
    x0 = jnp.zeros((B, 6), jnp.float32)
    V0 = jnp.zeros((B, N, 2), jnp.float32)
    ctlr = mpc_mod.PMPCBatch(N=N, dt=DT)

    # The same closed loop for the first n lanes on the CPU, through the
    # same fixed-budget body under XLA: compiled here, run in a thread
    # while the GPU work below goes on.
    t0 = time.perf_counter()
    cpu = jax.devices("cpu")[0]
    sub = jax.device_put((mus[:n], aux.target[:n], x0[:n], V0[:n]), cpu)
    with jax.default_device(cpu), route_mod.forced("xla"):
        cpu_loop = closed_loop_fn(ctlr, sub[0], sub[1], Tc).lower(
            sub[2], sub[3]).compile()
    cpu_out = {}

    def run_cpu():
        try:
            cpu_out["x"] = np.asarray(cpu_loop(sub[2], sub[3])[0])
        except Exception as e:          # reported by the check below
            cpu_out["error"] = repr(e)

    cpu_thread = threading.Thread(target=run_cpu, daemon=True)
    cpu_thread.start()
    log(f"  cpu loop compiled and started ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    xf, _, pos = closed_loop_fn(ctlr, mus, aux.target, T, track=n)(x0, V0)
    err = np.hypot(np.asarray(xf[:, 0] - aux.target[:, 0]),
                   np.asarray(xf[:, 2] - aux.target[:, 2]))
    q = {"quality_success_at_1cm": float(np.mean(err < 0.01)),
         "quality_mean_final_err_mm": float(np.mean(err) * 1e3)}
    log(f"  closed loop B={B} steps={T}: {json.dumps(q)} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    check(np.all(np.isfinite(err)), "closed loop: non-finite states")
    check(q["quality_success_at_1cm"] >= 0.99, "closed loop quality")
    gpu_pos = np.asarray(pos[Tc - 1])

    def run_cli(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        check(rc == 0, f"{main.__module__} exited {rc}")
        return json.loads(buf.getvalue())

    rt = SIZES["cli_runtime"]
    t0 = time.perf_counter()
    out = run_cli(cli_pmpc.main, ["--target", "0.05", "-0.04",
                                  "--object_name", "cube", "--runtime", rt])
    log(f"  cli pmpc: {json.dumps(out)} ({time.perf_counter() - t0:.1f} s)")
    check(np.isfinite(out["steady_state_error"]), "cli pmpc: non-finite")
    t0 = time.perf_counter()
    out = run_cli(cli_sweep.main, ["--controller", "rmpc", "--batch_major",
                                   "--runtime", rt])
    s = out["summary"]
    log(f"  cli sweep rmpc --batch_major: {json.dumps(s)} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(s["n"] == 18 and np.isfinite(s["mean_sse_mm"]),
          "cli sweep: wrong grid or non-finite errors")

    t0 = time.perf_counter()
    lctlr = mpc_mod.LMPC(N=4, dt=0.02, cfg=mpc_mod.ilqr.ILQRConfig(
        max_iters=2, al_iters=1, n_alphas=4))
    env_cfg = trainer.EnvConfig(dt=0.02, max_episode_steps=32)
    model = ppo_mod.ActorCritic(act_dim=trainer.N_PARAMS)
    step, tx = trainer.make_train_step(
        model, lctlr, env_cfg, ppo_mod.PPOConfig(epochs=1, minibatch_size=64),
        rollout_len=64)
    ts = trainer.init_train_state(jax.random.PRNGKey(0), model, tx)
    envs = jax.vmap(lambda r: trainer.env_init(r, lctlr, env_cfg))(
        jax.random.split(jax.random.PRNGKey(1), 8))
    ts2, _, stats = jax.jit(step)(ts, envs)
    moved = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(
        jax.tree.leaves(ts2.params), jax.tree.leaves(ts.params)))
    log(f"  ppo update: mean_reward={float(stats['mean_reward']):.4f} "
        f"max_param_step={moved:.3e} ({time.perf_counter() - t0:.1f} s)")
    check(np.isfinite(float(stats["mean_reward"])) and 0 < moved < 1,
          "ppo update: non-finite or no update")

    t0 = time.perf_counter()
    cpu_thread.join(timeout=900)
    check(not cpu_thread.is_alive() and "x" in cpu_out,
          f"cpu closed loop did not finish: {cpu_out.get('error')}")
    xc = cpu_out["x"]
    dpos = np.hypot(gpu_pos[:, 0] - xc[:, 0], gpu_pos[:, 1] - xc[:, 2])
    log(f"  position after {Tc} steps vs cpu ({n} lanes): max "
        f"{dpos.max() * 1e3:.4f} mm (waited {time.perf_counter() - t0:.1f} s)")
    check(dpos.max() < 1e-3, "closed loop: GPU and CPU differ by >= 1 mm")


def phase_kernel_vs_xla():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dart_tpu.control import mpc as mpc_mod
    from dart_tpu.ops import route as route_mod

    T, reps = SIZES["time_steps"], SIZES["time_reps"]
    results = {}
    for B in SIZES["time_batches"]:
        mus, aux, _, _ = pmpc_problem(B, seed=3)
        x0 = jnp.zeros((B, 6), jnp.float32)
        V0 = jnp.zeros((B, N, 2), jnp.float32)
        for label, route in (("triton", "triton"), ("xla", "xla"),
                             ("solve_batch_fast", None)):
            ctlr = mpc_mod.PMPCBatch(N=N, dt=DT, use_kernel=route is not None)
            loop = closed_loop_fn(ctlr, mus, aux.target, T)
            ctx = route_mod.forced(route) if route else contextlib.nullcontext()
            with ctx:                       # the route is read while tracing
                t0 = time.perf_counter()
                jax.block_until_ready(loop(x0, V0))
                compile_s = time.perf_counter() - t0
            times = []
            for r in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(loop(x0 + 1e-4 * (r + 1), V0))
                times.append(time.perf_counter() - t0)
            step_us = [1e6 * t / T for t in times]
            results[f"{label}@{B}"] = float(np.median(step_us))
            log(f"  B={B} {label}: per-step median {np.median(step_us):.2f} "
                f"us (reps {[round(s, 2) for s in step_us]}); first call "
                f"{compile_s:.1f} s")
    log(f"  kernel_vs_xla: {json.dumps(results)}")
    B0 = SIZES["time_batches"][0]
    log(f"  decision at B={B0}: " + (
        "Triton kernel faster" if results[f"triton@{B0}"]
        < results[f"xla@{B0}"] else "plain XLA faster"))


def phase_multichip():
    import jax
    import numpy as np

    import __graft_entry__ as graft
    from dart_tpu.io import scenes
    from dart_tpu.ops.pallas.pmpc_solve import BLOCK
    from dart_tpu.parallel import sweep as sweep_mod
    from dart_tpu.rollout.evaluate import make_pmpc_batch_evaluator

    t0 = time.perf_counter()
    graft.dryrun_multichip(4)
    log(f"  dryrun_multichip(4) ok ({time.perf_counter() - t0:.1f} s)")

    batch = scenes.sweep_grid(
        targets=((0.05, -0.04), (0.08, 0.06), (-0.06, 0.03),
                 (-0.03, -0.07)))
    ev = make_pmpc_batch_evaluator(n_steps=SIZES["sweep_steps"], dt=DT,
                                   control_every=5, warmup_steps=250)
    lane = inspect.signature(sweep_mod.run_sweep_batched).parameters[
        "lane_multiple"].default
    log(f"  scenarios={batch.size} lane_multiple={lane} "
        f"(PMPC kernel block {BLOCK})")
    check(lane == BLOCK, "sweep pads to a different lane multiple")
    out = {}
    for n_dev in (4, 1):
        t0 = time.perf_counter()
        res, agg = sweep_mod.run_sweep_batched(ev, batch,
                                               sweep_mod.make_mesh(n_dev))
        m = jax.tree.map(np.asarray, res.metrics)
        out[n_dev] = m
        log(f"  sweep on {n_dev} GPU(s): success "
            f"{float(agg.n_converged) / float(agg.n):.4f} mean_sse_mm "
            f"{float(agg.mean_sse) * 1e3:.4f} ({time.perf_counter() - t0:.1f}"
            " s incl. compile)")
    # Lanes are independent, so only float reassociation (XLA may fuse the
    # plant and metrics differently at another shard size) separates the
    # two runs: 10 um of final error, 1% of control effort and one control
    # period (10 ms) of convergence time are far inside the 1 cm task
    # tolerance.
    a, b = out[4], out[1]
    fin = np.isfinite(a.convergence_time) & np.isfinite(b.convergence_time)
    d = {"steady_state_error_m": float(np.max(np.abs(
             a.steady_state_error - b.steady_state_error))),
         "control_effort_rel": float(np.max(np.abs(
             a.control_effort - b.control_effort)
             / np.maximum(np.abs(b.control_effort), 1e-6))),
         "convergence_time_s": float(np.max(np.abs(
             a.convergence_time[fin] - b.convergence_time[fin]),
             initial=0.0))}
    log(f"  4 vs 1 GPU per-scenario max |diff|: {json.dumps(d)}")
    check(np.array_equal(a.converged, b.converged)
          and np.array_equal(np.isfinite(a.convergence_time),
                             np.isfinite(b.convergence_time)),
          "converged flags differ between 4 and 1 GPUs")
    check(d["steady_state_error_m"] < 1e-5 and d["control_effort_rel"] < 1e-2
          and d["convergence_time_s"] <= 5 * DT + 1e-9,
          "per-scenario metrics differ between 4 and 1 GPUs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the 4-GPU sharded paths")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "dart_tpu")):
        print(f"chip_smoke: no dart_tpu package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    from dart_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    want = 4 if args.multichip else 1
    phases = [("device", lambda: phase_device(devs, want))]
    if args.multichip:
        phases.append(("multichip", phase_multichip))
    else:
        phases += [("pmpc_parity", phase_pmpc_parity), ("tf32", phase_tf32),
                   ("closed_loop", phase_closed_loop),
                   ("kernel_vs_xla", phase_kernel_vs_xla)]
    failed = []
    for name, fn in phases:
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:        # reported, and the run exits nonzero
            traceback.print_exc()
            failed.append(name)
            log(f"== {name} FAILED ({time.perf_counter() - t0:.1f} s)")
            if name == "device":
                break
            continue
        log(f"== {name} ok ({time.perf_counter() - t0:.1f} s)")
    if failed:
        log(f"chip_smoke: failed phases: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
