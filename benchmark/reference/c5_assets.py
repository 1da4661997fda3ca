"""The ``c5`` configuration's inputs, made from the run's seed: the
displaced UV-sphere mesh (as an OBJ text and as the float32 arrays a
loader reads from it), the lat-long HDRI and the glossy MERL table.

Plain NumPy.  The benchmark hands the same inputs to the program (through
its loaders) and to the plain reference (``c5.py``), which rebuilds from
them whatever the program derives (normals, tangents, the search tree).
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, salt])


def _lobe_dirs(rng, n):
    d = rng.standard_normal((n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def mesh(cfg: dict, seed: int):
    """The UV sphere of ``cfg["mesh"]`` (radius, n_theta = n_phi rings and
    segments, the poles as single triangles: ``2 n (n - 1)`` triangles),
    each vertex moved along its direction by seeded lobes: ``r = radius *
    clip(1 + sum_k a_k exp((d . c_k - 1) / w^2), lo, hi)`` with the
    configuration's amplitudes ``a_k`` and width ``w`` and seeded lobe
    centres ``c_k``.  Returns (positions [V,3] float64, uvs [V,2], faces
    [F,3] int64, 0-based)."""
    m = cfg["mesh"]
    n_t, n_p, radius = m["n_theta"], m["n_phi"], m["radius"]
    amps = np.asarray(m["lobe_amplitudes"], np.float64)
    centres = _lobe_dirs(_rng(seed, 1), len(amps))
    i = np.arange(n_t + 1)[:, None]
    j = np.arange(n_p + 1)[None, :]
    theta = np.pi * i / n_t
    phi = 2 * np.pi * j / n_p
    d = np.stack(np.broadcast_arrays(np.sin(theta) * np.cos(phi), np.cos(theta),
                                     np.sin(theta) * np.sin(phi)), -1).reshape(-1, 3)
    bump = np.exp((d @ centres.T - 1.0) / m["lobe_width"] ** 2) @ amps
    r = radius * np.clip(1.0 + bump, *m["radius_clip"])
    pos = d * r[:, None]
    uv = np.stack(np.broadcast_arrays(j / n_p + 0 * i, 1 - i / n_t + 0 * j),
                  -1).reshape(-1, 2).astype(np.float64)
    cols = n_p + 1
    ii, jj = np.meshgrid(np.arange(n_t), np.arange(n_p), indexing="ij")
    a = ii * cols + jj
    b, c = a + 1, a + cols
    dd = c + 1
    # Quad by quad, (a, b, c) but in the top ring, then (b, d, c) but in
    # the bottom one.
    faces = np.empty((ii.size * 2, 3), np.int64)
    faces[0::2] = np.stack([a, b, c], -1).reshape(-1, 3)
    faces[1::2] = np.stack([b, dd, c], -1).reshape(-1, 3)
    keep = np.empty(ii.size * 2, bool)
    keep[0::2] = (ii > 0).reshape(-1)
    keep[1::2] = (ii < n_t - 1).reshape(-1)
    return pos, uv, faces[keep]


def obj_text(pos, uv, faces) -> str:
    """The OBJ a loader reads: 6 decimals a coordinate, ``f v/vt``."""
    out = [("v %.6f %.6f %.6f\n" * len(pos)) % tuple(pos.ravel()),
           ("vt %.6f %.6f\n" * len(uv)) % tuple(uv.ravel())]
    f1 = faces + 1
    out.append(("f %d/%d %d/%d %d/%d\n" * len(f1))
               % tuple(np.repeat(f1, 2, axis=1).ravel()))
    return "".join(out)


def as_read(x) -> np.ndarray:
    """What a float32 loader reads from the 6-decimal text of ``x``."""
    return np.round(np.asarray(x, np.float64), 6).astype(np.float32)


def as_loaded(pos) -> np.ndarray:
    """The float32 positions a loader holds after reading ``pos`` from the
    OBJ text and moving them to their centroid: the float32 sum in file
    order, times the float32 reciprocal of the count, subtracted."""
    p = as_read(pos)
    total = np.cumsum(p, axis=0, dtype=np.float32)[-1]
    centroid = total * (np.float32(1.0) / np.float32(len(p)))
    return p - centroid


def hdri(cfg: dict, seed: int) -> np.ndarray:
    """The [H,W,3] float32 lat-long sky: the gradient (red fading up, blue
    rising, a constant green) and a seeded sun, a Gaussian disc of the
    configuration's angular radius and radiance above the horizon."""
    h, w = cfg["hdri"]["height"], cfg["hdri"]["width"]
    v = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = np.concatenate([1.2 * (1 - v), 0.7 * np.ones((h, 1, 1), np.float32),
                          1.2 * v], axis=2)
    img = np.broadcast_to(img, (h, w, 3)).astype(np.float32)
    rng = _rng(seed, 2)
    sun = _lobe_dirs(rng, 1)[0]
    sun[1] = abs(sun[1]) * 0.8 + 0.2
    sun /= np.linalg.norm(sun)
    # Texel directions as the environment fetch maps them: u = atan2(x, z)
    # over [0, 2 pi), v = acos(y) / pi.
    uu = (np.arange(w) + 0.5) / w * 2 * np.pi
    vv = (np.arange(h) + 0.5) / h * np.pi
    dirs = np.stack(np.broadcast_arrays(np.sin(vv)[:, None] * np.sin(uu)[None, :],
                                        np.cos(vv)[:, None] + 0 * uu[None, :],
                                        np.sin(vv)[:, None] * np.cos(uu)[None, :]), -1)
    ang = np.arccos(np.clip(dirs @ sun, -1, 1))
    disc = np.exp(-(ang / np.radians(cfg["hdri"]["sun_radius_deg"])) ** 2)
    img += (cfg["hdri"]["sun_radiance"] * disc)[..., None].astype(np.float32) * \
        np.asarray(cfg["hdri"]["sun_tint"], np.float32)
    return np.ascontiguousarray(img, dtype=np.float32)


def merl(cfg: dict, seed: int) -> np.ndarray:
    """The raw [3, 90*90*180] glossy MERL table (before the per-channel
    scales): a theta_h lobe over a floor, of seeded width and tint."""
    g = cfg["brdf"]
    rng = _rng(seed, 3)
    width = rng.uniform(*g["lobe_width_range"])
    tint = rng.uniform(*g["tint_range"], size=3)
    th = ((np.arange(90) + 0.5) / 90) ** 2 * (np.pi / 2)
    prof = g["amplitude"] * np.exp(-((th / width) ** 2)) + g["floor"]
    t = prof[None, :, None] * tint[:, None, None]
    return np.ascontiguousarray(
        np.broadcast_to(t, (3, 90, 90 * 180)).reshape(3, -1), dtype=np.float32)

