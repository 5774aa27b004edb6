"""dart_tpu — a batched JAX framework for dual-arm non-prehensile manipulation.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
`dart-icra/DART-Dual-Arm-Non-Prehensile-Manipulation`:

- ``models``   : pure-JAX transition models (PMPC analytic, RMPC regressor,
                 LMPC 34-parameter Stribeck/rolling/toppling model).
- ``solver``   : batched constrained trajectory optimisation (box-DDP /
                 AL-iLQR) replacing CasADi+IPOPT.
- ``ops``      : hot kernels (box-QP, lane algebra, the PMPC whole-solve
                 Triton kernel, the route decision).
- ``control``  : tray-tilt MPC front-ends, dual-arm coordination (DACTL),
                 impedance-QP arm controller.
- ``adapt``    : online adaptation (RLS, PPO in JAX/Optax).
- ``rollout``  : jit-compiled closed-loop engines (lax.scan) replacing the
                 reference's multiprocessing orchestration.
- ``physics``  : JAX rigid-body plant models (tray-object contact,
                 articulated arm dynamics) replacing MuJoCo on the hot path.
- ``parallel`` : device-mesh sharding of scenario sweeps and ensembles.
- ``io``       : typed configs and observability (log schemas of the
                 reference: 17-channel npz, episodic npy, JSON episodes).

The reference's process/shared-memory topology (SURVEY.md section 2.6) exists
only because IPOPT/MuJoCo are single-threaded CPU libraries; here every
control step is one jitted dataflow program and parallelism is batching over
`vmap`/mesh axes.
"""

__version__ = "0.1.0"
