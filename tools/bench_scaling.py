"""Mesh scaling measurement -> artifacts/scaling_r3.json (VERDICT r2 next-5).

On a pod slice this measures real scaling efficiency (episodes/s at n
chips vs n x single-chip). Only one real chip is reachable here, so the
tool measures the three things that CAN be measured honestly and records
them together:

1. WEAK SCALING on virtual CPU devices (1/2/4/8): wall time for per_dev
   episodes per device. On this host the curve is CORE-BOUND (nproc is
   recorded next to it) — with 2 cores, efficiency at 2 devices is the
   real parallelism signal and the 4/8-device points measure sharding
   overhead on oversubscribed cores, not the design.
2. COLLECTIVE CENSUS of the compiled 8-device sharded program
   (`parallel.sweep.sweep_hlo`): the scenario axis is pure data
   parallelism, so the only collectives in the optimized HLO must be the
   final metric-aggregate psums, with a count INDEPENDENT of device
   count. This is the measured, compiled-program form of the scaling
   claim ("collective-free episode body") — interconnect traffic per episode
   is literally zero, so multi-chip efficiency is bounded by launch
   overheads, not communication.
3. 2-PROCESS DCN PATH: the same sweep through `jax.distributed` across
   two OS processes (1 virtual device each), wall-time-compared against
   the single-process 2-device run — exercises the real multi-host code
   path end to end.

    python tools/bench_scaling.py --cpu     # writes artifacts/scaling_r3.json
"""

import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

PER_DEV = 32
N_STEPS = 500


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_DCN_WORKER = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    # Shared persistent compile cache across BOTH processes: each process
    # otherwise pays the full sweep compile.
    from dart_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from dart_tpu.parallel import mesh as mesh_mod

    ok = mesh_mod.init_distributed(coordinator_address={addr!r},
                                   num_processes=2,
                                   process_id=int(sys.argv[1]))
    assert ok and jax.process_count() == 2
    # heavy imports AFTER init_distributed: module-level jnp constants
    # (e.g. control.mpc weight tables) would initialise the backend early
    import jax.numpy as jnp
    import numpy as np
    from dart_tpu.parallel import sweep as sweep_mod
    from dart_tpu.io import scenes
    from dart_tpu.rollout.evaluate import make_pmpc_evaluator
    mesh = mesh_mod.global_mesh()
    ev = make_pmpc_evaluator(n_steps={n_steps}, dt=0.002, control_every=5,
                             warmup_steps=100, max_iters=4)
    rng = np.random.default_rng(0)
    batch = scenes.random_scenarios(rng, {per_dev} * jax.device_count(),
                                    dtype=jnp.float32)
    t0 = time.time()
    sweep_mod.run_sweep(ev, batch, mesh)          # compile
    t_compile = time.time() - t0
    # Per-dispatch overhead floor (VERDICT r4 next-6 profile): a trivial
    # cross-process collective, timed like the real thing (dispatch +
    # collective + host fetch).
    from jax.sharding import PartitionSpec as P
    tiny = jax.jit(jax.shard_map(
        lambda x: jax.lax.psum(x, "scenario"), mesh=mesh,
        in_specs=P("scenario"), out_specs=P(), check_vma=False))
    xs = jnp.arange(jax.device_count(), dtype=jnp.float32)
    float(jnp.sum(tiny(xs)))                       # compile
    disp = []
    for _ in range(7):
        td = time.time()
        float(jnp.sum(tiny(xs)))
        disp.append(time.time() - td)
    reps = []
    for _ in range(3):
        t0 = time.time()
        res, agg = sweep_mod.run_sweep(ev, batch, mesh)
        jax.block_until_ready(agg)
        reps.append(time.time() - t0)
    # Median, matching the single-process weak-scaling statistic exactly
    # (ADVICE r4: min-vs-median mixing biased the committed efficiency up).
    el = sorted(reps)[1]
    if jax.process_index() == 0:
        print("DCN_REPS", " ".join("%.2f" % r for r in reps))
        print("DCN_PHASES", "%.2f" % t_compile,
              "%.4f" % sorted(disp)[len(disp) // 2])
        print("DCN_RESULT", el, batch.size, float(agg.n))
""")


def measure_dcn(per_dev, n_steps):
    addr = f"127.0.0.1:{_free_port()}"
    script = os.path.join(tempfile.mkdtemp(), "_scaling_dcn_worker.py")
    with open(script, "w") as f:
        f.write(_DCN_WORKER.format(repo=REPO, addr=addr, per_dev=per_dev,
                                   n_steps=n_steps))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)   # 1 device per process
    # r4 (VERDICT r3 next-8): pin each process to its own core. Without
    # affinity both processes size their XLA-CPU intra-op pools to nproc,
    # so 2 processes x nproc threads thrash the same cores — that alone
    # was the r3 DCN gap (65% of the single-process 2-device rate).
    ncores = os.cpu_count() or 1
    have_taskset = subprocess.run(["which", "taskset"],
                                  capture_output=True).returncode == 0

    def argv_for(pid):
        base = [sys.executable, script, str(pid)]
        if have_taskset and ncores >= 2:
            return ["taskset", "-c", str(pid % ncores)] + base
        return base

    procs = [subprocess.Popen(argv_for(pid),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for pid in range(2)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"DCN proc {pid} failed:\n{out[-2000:]}")
    m = re.search(r"DCN_RESULT ([\d.]+) (\d+)", outs[0] + outs[1])
    assert m, outs
    el, size = float(m.group(1)), int(m.group(2))
    rep = re.search(r"DCN_REPS ([\d. ]+)", outs[0] + outs[1])
    out = {"processes": 2, "devices": 2, "episodes": size,
           "wall_s": round(el, 2), "episodes_per_s": round(size / el, 2)}
    if rep:
        out["rep_walls_s"] = [float(x) for x in rep.group(1).split()]
    ph = re.search(r"DCN_PHASES ([\d.]+) ([\d.]+)", outs[0] + outs[1])
    if ph:
        # dispatch floor = one trivial cross-process collective round;
        # compute = wall - dispatch (one dispatch per sweep rep).
        out["compile_s"] = float(ph.group(1))
        out["dispatch_floor_s"] = float(ph.group(2))
        out["phase_split"] = {
            "dispatch_s": float(ph.group(2)),
            "compute_s": round(el - float(ph.group(2)), 3)}
    return out


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU (env vars are too late here); pair with "
                         "XLA_FLAGS=--xla_force_host_platform_device_count=8")
    ap.add_argument("--out", default="artifacts/scaling_r4.json")
    ap.add_argument("--skip_dcn", action="store_true")
    ap.add_argument("--all_devices", action="store_true",
                    help="also time device counts > nproc (core-bound "
                         "points: oversubscription diagnostics, NOT "
                         "scaling evidence; the committed curve excludes "
                         "them — VERDICT r3 next-8)")
    args = ap.parse_args()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from dart_tpu.io import scenes
    from dart_tpu.parallel import sweep as sweep_mod
    from dart_tpu.rollout.evaluate import make_pmpc_evaluator

    n_total = len(jax.devices())
    ev = make_pmpc_evaluator(n_steps=N_STEPS, dt=0.002, control_every=5,
                             warmup_steps=100, max_iters=4)
    rng = np.random.default_rng(0)

    # 1. weak scaling — only device counts with a physical core each are
    # committed as scaling evidence (beyond nproc the virtual devices
    # time-share cores and the numbers measure oversubscription).
    ncap = n_total if args.all_devices else min(n_total,
                                                os.cpu_count() or 1)
    weak = []
    base_rate = None
    for n in [k for k in (1, 2, 4, 8, 16, 32) if k <= ncap]:
        batch = scenes.random_scenarios(rng, PER_DEV * n, dtype=jnp.float32)
        mesh = sweep_mod.make_mesh(n)
        sweep_mod.run_sweep(ev, batch, mesh)      # compile
        reps = []
        for _ in range(3):
            t0 = time.time()
            _, agg = sweep_mod.run_sweep(ev, batch, mesh)
            jax.block_until_ready(agg)
            reps.append(time.time() - t0)
        el = float(np.median(reps))
        rate = batch.size / el
        if base_rate is None:
            base_rate = rate
        weak.append({"devices": n, "episodes": batch.size,
                     "wall_s": round(el, 2),
                     "episodes_per_s": round(rate, 2),
                     "efficiency_vs_1dev": round(rate / (base_rate * n), 3)})
        print(json.dumps(weak[-1]), flush=True)

    # 2. collective census of the compiled sharded program
    census = []
    for n in [k for k in (2, 8) if k <= n_total]:
        batch = scenes.random_scenarios(rng, PER_DEV * n, dtype=jnp.float32)
        hlo = sweep_mod.sweep_hlo(ev, batch, sweep_mod.make_mesh(n))
        counts = {op: len(re.findall(rf"\b{op}\b", hlo))
                  for op in ("all-reduce", "all-gather", "all-to-all",
                             "collective-permute", "reduce-scatter")}
        census.append({"devices": n, "collectives": counts,
                       "hlo_bytes": len(hlo)})
        print(json.dumps(census[-1]), flush=True)
    if len(census) == 2:
        same = census[0]["collectives"] == census[1]["collectives"]
        print(f"[scaling] collective count device-count-invariant: {same}")

    # 3. 2-process DCN path
    dcn = None
    if not args.skip_dcn:
        dcn = measure_dcn(PER_DEV, N_STEPS)
        ref = next((w for w in weak if w["devices"] == 2), None)
        if ref is not None:
            dcn["efficiency_vs_singleproc_2dev"] = round(
                dcn["episodes_per_s"] / ref["episodes_per_s"], 3)
        print(json.dumps(dcn), flush=True)

    out = {
        "platform": jax.default_backend(),
        "nproc": os.cpu_count(),
        "note": ("weak-scaling curve limited to device counts <= nproc "
                 "(each virtual device gets a physical core; beyond that "
                 "the numbers measure core oversubscription, not the "
                 "design — r3 committed those points, r4 drops them); "
                 "the collective census is the device-count-independent "
                 "evidence (aggregate-only collectives => per-episode "
                 "interconnect traffic is zero); the 2 processes are core-pinned "
                 "via taskset"),
        "episode_steps": N_STEPS, "episodes_per_device": PER_DEV,
        "weak_scaling": weak, "collective_census": census,
        "dcn_2process": dcn,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[scaling] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
