"""A procedural UV-sphere OBJ: the mesh the repository's tests and benches
render in place of a scanned model.

The same vertices, uvs and faces as ``tests/test_mesh_render.py``'s
``write_uv_sphere`` (copied, since the port imports nothing of the JAX
package's tests): ``n_theta`` rings of ``n_phi`` quads, the pole rings as
single triangles, so ``2 * n_phi * (n_theta - 1)`` triangles in all.
"""

from __future__ import annotations

import numpy as np


def write_uv_sphere(path, radius=12.0, n_theta=12, n_phi=18):
    verts, uvs, faces = [], [], []
    for i in range(n_theta + 1):
        theta = np.pi * i / n_theta
        for j in range(n_phi + 1):
            phi = 2 * np.pi * j / n_phi
            verts.append((
                radius * np.sin(theta) * np.cos(phi),
                radius * np.cos(theta),
                radius * np.sin(theta) * np.sin(phi),
            ))
            uvs.append((j / n_phi, 1 - i / n_theta))
    cols = n_phi + 1
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * cols + j
            b = a + 1
            c = a + cols
            d = c + 1
            if i > 0:
                faces.append((a, b, c))
            if i < n_theta - 1:
                faces.append((b, d, c))
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for u in uvs:
            f.write(f"vt {u[0]:.6f} {u[1]:.6f}\n")
        for a, b, c in faces:
            f.write(f"f {a+1}/{a+1} {b+1}/{b+1} {c+1}/{c+1}\n")
