"""Household-object presets: the ENTIRE reference object pack as rows.

The reference ships ~57 extra object MJCFs (`PMPC/object_sim/<name>/`,
SURVEY C15e) plus scene variants (`world_{bowl,...}.xml`,
`burger_on_plate.xml`). In the tray_object parameter space a scene is a
parameter row, so each asset reduces to {mass, footprint half-widths, COM
height, rolling signature, rocking mask}. The rows are EXTRACTED from the
reference's own compiled models (`tools/extract_object_presets.py`:
`body_subtreemass`, contact-geom `geom_aabb` footprint, `body_ipos` COM
height, `body_inertia` for the rolling factor) — not guessed, and live in
the generated module `object_presets_data.py`.

Rolling (r3, VERDICT r2 next-7): round resting shapes (apple, sphere*)
roll on both axes with kappa_inv = m r^2 / I computed from the compiled
inertia; the cylinder family additionally gets side-lying `<name>_side`
variants that ROLL across their circular section (the reference's own
sweep precedent: its cylinders lie and roll per the world keyframes) —
e.g. `waterbottle_side`. Everything else slides and can rock/topple about
its flat support axes (`tray_object` rocking terms, `rlmpc2.py:734-736`).
"""

from __future__ import annotations

import jax.numpy as jnp

from dart_tpu.physics.object_presets_data import PRESET_ROWS
from dart_tpu.physics.tray_object import (CALIBRATED_ROLL_RESIST,
                                          CALIBRATED_SLIDE_DAMP,
                                          CALIBRATED_TRAY_LAG,
                                          LEGACY_TRAY_LAG, TrayObjectParams)

# name -> (mass kg, half_w x, half_w y, h_com m,
#          kappa_inv_x, kappa_inv_y, topple_x, topple_y)
PRESETS = dict(PRESET_ROWS)
# Back-compat alias for the r2 preset name (pack name is "fryingpan").
PRESETS["pan"] = PRESETS["fryingpan"]


def make_preset_params(name: str, mu: float = 0.3,
                       tray_height: float = 0.4,
                       slip_eps: float = 2e-3, dtype=jnp.float32,
                       mass: float | None = None,
                       calibrated: bool = True) -> TrayObjectParams:
    """TrayObjectParams for a named pack preset (see PRESETS).

    ``calibrated`` (default) applies the MuJoCo-measured tray lag and
    transfers the tray-contact dissipation calibration: rollers get the
    sphere/cylinder rolling resistance, sliders the cube tangential
    damping (`tray_object.CALIBRATED_*`, the r3 re-baseline). Pass False
    for the undamped legacy plant.
    """
    m0, hx, hy, hcom, kx, ky, tx, ty = PRESETS[name]
    a = lambda x: jnp.asarray(x, dtype)
    rolls = kx > 0 or ky > 0
    m_eff = mass if mass is not None else m0
    if calibrated:
        # r4: payload-mass-interpolated lag (the arm stack slows with the
        # carried mass; see tray_object.calibrated_lag).
        from dart_tpu.physics.tray_object import calibrated_lag
        omega_n, zeta, lag_fast = calibrated_lag(m_eff, dtype)
        rr = CALIBRATED_ROLL_RESIST["sphere" if ky > 0 else "cylinder"] \
            if rolls else 0.0
        from dart_tpu.physics.tray_object import (calibrated_roll_stick,
                                                  calibrated_slide_damp)
        sd = 0.0 if rolls else calibrated_slide_damp(
            CALIBRATED_SLIDE_DAMP["cube"], mu, dtype)
        rstick = calibrated_roll_stick(jnp.asarray([kx, ky], dtype), mu,
                                       dtype)
        from dart_tpu.physics.tray_object import (CALIBRATED_BACK_GSS,
                                                  CALIBRATED_BACK_W)
        bw = jnp.asarray(CALIBRATED_BACK_W, dtype)
        bg = jnp.asarray(CALIBRATED_BACK_GSS, dtype)
    else:
        omega_n, zeta, lag_fast = LEGACY_TRAY_LAG + (0.0,)
        rr, sd = 0.0, 0.0
        rstick = jnp.zeros(2, dtype)
        bw, bg = jnp.zeros(2, dtype), jnp.ones(2, dtype)
    return TrayObjectParams(
        mass=a(mass if mass is not None else m0), mu=a(mu),
        kappa_inv=a([kx, ky]),
        slip_eps=a(slip_eps), omega_n=a(omega_n), zeta=a(zeta),
        tray_pos=a([0.0, 0.0, tray_height]),
        half_w=a([hx, hy]), h_com=a(hcom),
        topple_on=a([tx, ty]),
        roll_resist=a(rr), slide_damp=a(sd), lag_fast=a(lag_fast),
        roll_stick=rstick, stick_vel=a(5e-3), back_w=bw, back_gss=bg)
