"""Extract household-object presets from the ENTIRE reference object pack.

The reference ships ~57 extra object MJCFs (`PMPC/object_sim/<name>/`,
SURVEY C15e) plus 6 `world_{name}.xml` scene variants. This tool compiles
EVERY pack object into a probe world (data extraction from the compiled
model — not code copying) and reduces each to the parameter row the
tray_object contact model consumes:

  mass              body_subtreemass
  footprint         xy half-extents of the contact-geom AABB union
  COM height        body_ipos z above the AABB bottom
  rolling signature classified from the NORMALISED inertia
                    I_mean / (m r_eff^2): ~0.40 -> sphere-like roller
                    (rolls both axes, kappa_inv = m r^2 / I), ~0.67 ->
                    cube-like slider; requires a near-isotropic AABB so
                    elongated or flat objects stay sliders
  rocking mask      rolling axes cannot rock (tray_object convention)

Side-lying variants (`<name>_side`) are generated for the cylinder-family
objects (cylinder*/waterbottle/flashlight/flute) following the reference's
own precedent that cylinders LIE and ROLL in its sweep keyframes: the
footprint becomes (length/2, r), h_com = r, and the travel axis across the
circular section gets kappa_inv = m r^2 / I_long (I_long = the smallest
principal moment, the spin axis).

Writes `dart_tpu/physics/object_presets_data.py` (generated data module).

Usage: python tools/extract_object_presets.py
"""

import os
import tempfile

import numpy as np

import mujoco

BASE = "/root/reference/PMPC/object_sim"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dart_tpu", "physics", "object_presets_data.py")

# Long thin circular-section objects with a side-lying rolling variant.
CYLINDER_FAMILY = ["cylinderlarge", "cylindermedium", "cylindersmall",
                   "waterbottle", "flashlight", "flute"]
# Curated gate for both-axis rollers: the normalised-inertia test alone
# over-classifies compact pointy objects (a pyramid's I/(m r^2) ~ 0.38
# sits inside the sphere band but it plainly cannot roll); only the
# genuinely round resting shapes qualify. The kappa value itself is still
# computed from the COMPILED inertia, not assumed.
ROUND_SHAPES = {"apple", "spherelarge", "spheremedium", "spheresmall"}


def probe(name):
    xml = f"""<mujoco model="probe">
  <compiler meshdir="{BASE}"/>
  <include file="{BASE}/common.xml"/>
  <include file="{BASE}/{name}/assets.xml"/>
  <worldbody>
    <body name="object" pos="0 0 0.2" childclass="grab">
      <include file="{BASE}/{name}/body.xml"/>
      <freejoint/>
    </body>
  </worldbody>
</mujoco>"""
    path = os.path.join(tempfile.mkdtemp(), f"_probe_{name}.xml")
    with open(path, "w") as f:
        f.write(xml)
    m = mujoco.MjModel.from_xml_path(path)
    b = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_BODY, "object")
    lo, hi = np.full(3, np.inf), np.full(3, -np.inf)
    for g in range(m.ngeom):
        if m.geom_bodyid[g] == b and m.geom_contype[g] != 0:
            c = m.geom_aabb[g][:3] + m.geom_pos[g]
            h = m.geom_aabb[g][3:]
            lo, hi = np.minimum(lo, c - h), np.maximum(hi, c + h)
    if not np.isfinite(lo).all():
        for g in range(m.ngeom):
            if m.geom_bodyid[g] == b:
                c = m.geom_aabb[g][:3] + m.geom_pos[g]
                h = m.geom_aabb[g][3:]
                lo, hi = np.minimum(lo, c - h), np.maximum(hi, c + h)
    ext = hi - lo
    return dict(mass=float(m.body_subtreemass[b]), ext=ext,
                com_h=float(m.body_ipos[b][2] - lo[2]),
                I=np.asarray(m.body_inertia[b], float))


def classify(name, row):
    """(kappa_inv_x, kappa_inv_y, topple_x, topple_y) for the as-modeled
    resting pose."""
    ext, I, mass = row["ext"], row["I"], row["mass"]
    r_eff = float(np.mean(ext)) / 2.0
    iso = float(ext.max() / max(ext.min(), 1e-9))
    i_ratio = float(I.max() / max(I.min(), 1e-12))
    i_norm = float(np.mean(I) / (mass * r_eff * r_eff))
    if (name in ROUND_SHAPES and iso < 1.25 and i_ratio < 1.2
            and 0.30 < i_norm < 0.52):
        k = min(max(1.0 / i_norm, 1.5), 3.5)    # sphere: 1/0.4 = 2.5
        return (round(k, 2), round(k, 2), 0.0, 0.0)
    return (0.0, 0.0, 1.0, 1.0)


def side_variant(row):
    """Side-lying cylinder-family row: rolls across the circular section."""
    ext, I, mass = row["ext"], row["I"], row["mass"]
    length = float(ext.max())
    r = float(np.sort(ext)[:2].mean()) / 2.0
    I_long = float(I.min())                      # spin axis moment
    k = min(max(mass * r * r / max(I_long, 1e-12), 1.5), 3.5)
    return dict(mass=mass, hx=round(r, 4), hy=round(length / 2.0, 4),
                h_com=round(r, 4), kx=round(k, 2), ky=0.0,
                tx=0.0, ty=1.0)


def main():
    names = sorted(d for d in os.listdir(BASE)
                   if os.path.isdir(os.path.join(BASE, d)))
    lines = []
    n_roll = 0
    for name in names:
        try:
            row = probe(name)
        except Exception as e:                            # noqa: BLE001
            print(f"[extract] {name}: FAILED {e}")
            continue
        kx, ky, tx, ty = classify(name, row)
        n_roll += kx > 0
        ext = row["ext"]
        lines.append(
            f'    "{name}": ({row["mass"]:.3f}, {ext[0] / 2:.4f}, '
            f'{ext[1] / 2:.4f}, {row["com_h"]:.4f}, {kx}, {ky}, '
            f'{tx}, {ty}),')
        if name in CYLINDER_FAMILY:
            sv = side_variant(row)
            lines.append(
                f'    "{name}_side": ({sv["mass"]:.3f}, {sv["hx"]}, '
                f'{sv["hy"]}, {sv["h_com"]}, {sv["kx"]}, {sv["ky"]}, '
                f'{sv["tx"]}, {sv["ty"]}),')
    # the canonical plate+payload variant scene (burger_on_plate.xml)
    lines.append('    "burger_on_plate": '
                 '(1.200, 0.1200, 0.1200, 0.0250, 0.0, 0.0, 1.0, 1.0),')
    body = "\n".join(lines)
    with open(OUT, "w") as f:
        f.write(
            '"""GENERATED by tools/extract_object_presets.py — do not edit.'
            '\n\nname -> (mass kg, half_w_x m, half_w_y m, h_com m,\n'
            '         kappa_inv_x, kappa_inv_y, topple_x, topple_y)\n'
            'extracted from the compiled reference object pack '
            '(`PMPC/object_sim/`).\n"""\n\nPRESET_ROWS = {\n'
            + body + "\n}\n")
    print(f"[extract] wrote {len(lines)} presets ({n_roll} rollers + "
          f"{sum(1 for ln in lines if '_side' in ln)} side-lying variants) "
          f"-> {OUT}")


if __name__ == "__main__":
    main()
