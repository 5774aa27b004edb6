"""JAX rigid-body dynamics for serial revolute chains (the xArm7 arms).

Replaces the MuJoCo dynamics queries on the reference's hot path
(`PMPC/src/controller/arm.py:111-199`): `mj_jacBody`, `mj_fullM`,
`mj_solveM`, `mj_jacDot`, `qfrc_bias`, body poses — all derived here from a
single differentiable forward-kinematics function:

- world joint frames by a `lax.scan` down the chain;
- Jacobians in closed form (revolute columns a_j x (p - p_j));
- mass matrix by the Gauss composite form  M = sum_i (m_i Jc_i' Jc_i +
  Jw_i' I_i Jw_i) + diag(armature);
- bias forces from autodiff of the Lagrangian:
  h = Mdot qd - dT/dq + dV/dq  (== Coriolis + gravity == mj qfrc_bias);
- Jdot via a jvp of the Jacobian along qd (replacing mj_jacDot);
- forward dynamics + semi-implicit Euler for plant stepping, with joint
  damping/armature/frictionloss from the MJCF defaults.

All functions are pure, jit/vmap/grad-safe; a dual-arm scene is just a
batch axis of size two.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dart_tpu.physics import xarm7_data as DATA
from dart_tpu.utils.quat import quat_to_matrix

GRAVITY = 9.81
N_JOINTS = 7


class ChainParams(NamedTuple):
    """Static description of one chain (8 bodies: link1..7 + lumped gripper).

    Offsets are parent-frame; joints rotate about the body-frame z axis and
    sit at the body origin (MJCF defaults of the xArm7 description).
    """

    base_pos: jnp.ndarray        # (3,) world position of chain root frame
    base_quat: jnp.ndarray       # (4,) world orientation of chain root frame
    body_pos: jnp.ndarray        # (8, 3) offset from parent body frame
    body_quat: jnp.ndarray       # (8, 4)
    mass: jnp.ndarray            # (8,)
    com: jnp.ndarray             # (8, 3) body-frame COM
    inertia: jnp.ndarray         # (8, 3, 3) about COM, body frame
    damping: jnp.ndarray         # (7,)
    armature: jnp.ndarray        # (7,)
    frictionloss: jnp.ndarray    # (7,)
    q_lo: jnp.ndarray            # (7,)
    q_hi: jnp.ndarray            # (7,)


def make_xarm7_chain(world_pos=(0.0, 0.0, 0.0), world_quat=(1.0, 0.0, 0.0, 0.0),
                     dtype=jnp.float32) -> ChainParams:
    """Build one xArm7 chain from the extracted MJCF data.

    `world_pos/quat` place the enclosing virtual-link frame (the reference
    mounts chains at (-0.7,0,-0.12)/quat(.707,0,0,-.707) and mirrored —
    `RMPC/models_dual/xarm7/world_general.xml:124-131`); the chain's own
    `L_link_base` offset (0,0,0.12) is composed in here.
    """
    a = lambda x: jnp.asarray(x, dtype)
    # Compose base: world_T_virtual * virtual_T_linkbase
    wq = np.asarray(world_quat, np.float64)
    wq = wq / np.linalg.norm(wq)
    wR = np.asarray(quat_to_matrix(jnp.asarray(wq)))
    bp = np.asarray(world_pos) + wR @ np.asarray(DATA.BASE["pos"])
    bq_local = np.asarray(DATA.BASE["quat"], np.float64)

    def qmul(q, r):
        w1, x1, y1, z1 = q
        w2, x2, y2, z2 = r
        return np.array([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ])

    bq = qmul(wq, bq_local / np.linalg.norm(bq_local))

    body_pos, body_quat, mass, com, inertia = [], [], [], [], []
    for link in DATA.LINKS:
        q = np.asarray(link["quat"], np.float64)
        q = q / np.linalg.norm(q)
        body_pos.append(link["pos"])
        body_quat.append(q)
        mass.append(link["mass"])
        com.append(link["com"])
        iq = np.asarray(link["icom_quat"], np.float64)
        iq = iq / np.linalg.norm(iq)
        R = np.asarray(quat_to_matrix(jnp.asarray(iq)))
        inertia.append(R @ np.diag(link["diaginertia"]) @ R.T)
    g = DATA.GRIPPER
    gq = np.asarray(g["quat"], np.float64)
    gq = gq / np.linalg.norm(gq)
    body_pos.append(g["pos"])
    body_quat.append(gq)
    mass.append(g["mass"])
    com.append(g["com"])
    inertia.append(np.asarray(g["inertia_full"]))

    return ChainParams(
        base_pos=a(bp), base_quat=a(bq),
        body_pos=a(body_pos), body_quat=a(body_quat),
        mass=a(mass), com=a(com), inertia=a(inertia),
        damping=a([l["damping"] for l in DATA.LINKS]),
        armature=a(DATA.ARMATURE),
        frictionloss=a(DATA.FRICTIONLOSS),
        q_lo=a([l["range"][0] for l in DATA.LINKS]),
        q_hi=a([l["range"][1] for l in DATA.LINKS]),
    )


# Full-precision products: a GPU may otherwise run float32 matmuls in TF32,
# which moved the forward dynamics by ~1e-4 relative on an H100 (PERF.md).
def mm(a, b):
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _rz(theta):
    c, s = jnp.cos(theta), jnp.sin(theta)
    z = jnp.zeros_like(theta)
    o = jnp.ones_like(theta)
    return jnp.stack([
        jnp.stack([c, -s, z], -1),
        jnp.stack([s, c, z], -1),
        jnp.stack([z, z, o], -1),
    ], -2)


class FK(NamedTuple):
    R: jnp.ndarray        # (8, 3, 3) world orientations (after joint rotation)
    p: jnp.ndarray        # (8, 3) world body-frame origins (joint anchors)
    axis: jnp.ndarray     # (7, 3) world joint axes
    com: jnp.ndarray      # (8, 3) world COM positions


def fk(params: ChainParams, q: jnp.ndarray) -> FK:
    R_par = quat_to_matrix(params.base_quat)
    p_par = params.base_pos
    Rs, ps = [], []
    for i in range(8):
        R_off = quat_to_matrix(params.body_quat[i])
        p_i = p_par + mm(R_par, params.body_pos[i])
        R_i0 = mm(R_par, R_off)
        if i < N_JOINTS:
            R_i = mm(R_i0, _rz(q[i]))
        else:
            R_i = R_i0
        Rs.append(R_i)
        ps.append(p_i)
        R_par, p_par = R_i, p_i
    R = jnp.stack(Rs)
    p = jnp.stack(ps)
    axis = R[:N_JOINTS, :, 2]      # z column (Rz commutes with z axis)
    com = p + jnp.einsum("bij,bj->bi", R, params.com,
                         precision=jax.lax.Precision.HIGHEST)
    return FK(R=R, p=p, axis=axis, com=com)


def point_jacobian(f: FK, point: jnp.ndarray, body: int) -> jnp.ndarray:
    """(6, 7) world Jacobian [Jv; Jw] of a world-frame point on `body`."""
    cols_v, cols_w = [], []
    for j in range(N_JOINTS):
        active = jnp.asarray(1.0 if j <= body else 0.0, point.dtype)
        a_j = f.axis[j] * active
        cols_v.append(jnp.cross(a_j, point - f.p[j]))
        cols_w.append(a_j)
    return jnp.concatenate([jnp.stack(cols_v, -1), jnp.stack(cols_w, -1)], 0)


def body_jacobian(params: ChainParams, q: jnp.ndarray,
                  body: int = 7) -> jnp.ndarray:
    """Jacobian of the body-frame origin (== mj_jacBody, `arm.py:120-126`)."""
    f = fk(params, q)
    return point_jacobian(f, f.p[body], body)


def mass_matrix(params: ChainParams, q: jnp.ndarray) -> jnp.ndarray:
    """(7, 7) joint-space inertia incl. armature (== mj_fullM block)."""
    f = fk(params, q)
    M = jnp.diag(params.armature)
    for i in range(8):
        body = min(i, 7)
        J6 = point_jacobian(f, f.com[i], body)
        Jv, Jw = J6[:3], J6[3:]
        I_w = mm(mm(f.R[i], params.inertia[i]), f.R[i].T)
        M = M + params.mass[i] * mm(Jv.T, Jv) + mm(mm(Jw.T, I_w), Jw)
    return 0.5 * (M + M.T)


def potential_energy(params: ChainParams, q: jnp.ndarray) -> jnp.ndarray:
    f = fk(params, q)
    return GRAVITY * jnp.sum(params.mass * f.com[:, 2])


def bias_forces(params: ChainParams, q: jnp.ndarray,
                qd: jnp.ndarray) -> jnp.ndarray:
    """Coriolis + gravity (== mjData.qfrc_bias, `arm.py:155`).

    h = Mdot qd - dT/dq + dV/dq, each term by autodiff of FK.
    """
    _, Mdot_qd = jax.jvp(lambda q_: mm(mass_matrix(params, q_), qd), (q,),
                         (qd,))
    dTdq = jax.grad(lambda q_: 0.5 * mm(mm(qd, mass_matrix(params, q_)),
                                        qd))(q)
    dVdq = jax.grad(lambda q_: potential_energy(params, q_))(q)
    return Mdot_qd - dTdq + dVdq


def jac_and_jacdot(params: ChainParams, q: jnp.ndarray, qd: jnp.ndarray,
                   body: int = 7, local_offset=None):
    """J and Jdot at a body point (replacing mj_jacBody + mj_jacDot).

    `local_offset` is expressed in the body frame (the reference's +0.125 m
    tool offset along the EE z axis, `arm.py:142-152, 157-165`).
    """
    def jac_of(q_):
        f = fk(params, q_)
        point = f.p[body]
        if local_offset is not None:
            point = point + mm(f.R[body], jnp.asarray(local_offset, q.dtype))
        return point_jacobian(f, point, body)

    J, Jdot = jax.jvp(jac_of, (q,), (qd,))
    return J, Jdot


def forward_dynamics(params: ChainParams, q: jnp.ndarray, qd: jnp.ndarray,
                     tau: jnp.ndarray, f_ext=None, ee_body: int = 7,
                     ee_offset=None) -> jnp.ndarray:
    """qdd given applied torques and optional EE wrench (world [F; T])."""
    M = mass_matrix(params, q)
    h = bias_forces(params, q, qd)
    passive = -params.damping * qd - params.frictionloss * jnp.tanh(qd / 1e-3)
    rhs = tau + passive - h
    if f_ext is not None:
        f = fk(params, q)
        point = f.p[ee_body]
        if ee_offset is not None:
            point = point + mm(f.R[ee_body], jnp.asarray(ee_offset,
                                                         q.dtype))
        J = point_jacobian(f, point, ee_body)
        rhs = rhs + mm(J.T, f_ext)
    return jnp.linalg.solve(M, rhs)


def step(params: ChainParams, q: jnp.ndarray, qd: jnp.ndarray,
         tau: jnp.ndarray, dt: float, f_ext=None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Semi-implicit Euler plant step (MuJoCo-style velocity-first)."""
    qdd = forward_dynamics(params, q, qd, tau, f_ext=f_ext)
    qd_new = qd + dt * qdd
    q_new = q + dt * qd_new
    return q_new, qd_new
