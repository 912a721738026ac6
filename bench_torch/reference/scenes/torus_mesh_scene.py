"""Twin of ``tpurt_torch.scene.torus_mesh_scene``: a 2*nu*nv-triangle
torus (material 2, moved to z = 6) and two glass spheres on a ground
sphere under one 5000 K square light."""

import math

import numpy as np

from bench_torch.reference.scene import (Desc, dielectric, diffuse,
                                         square_area)

# 256 triangles at 64x32 (the plain sweep pads a frame to 4096 lanes);
# 64 at 16x8, whose short jobs the fault tests run in seconds
SMALL_ARGS = {"nu": 16, "nv": 8}
TINY_ARGS = {"nu": 8, "nv": 4}


def _torus(nu: int, nv: int):
    """Vertices (nu*nv, 3) and outward-wound faces (2*nu*nv, 3)."""
    R0, r0 = 1.6, 0.55
    verts = np.empty((nu * nv, 3), np.float32)
    for i in range(nu):
        for j in range(nv):
            u = 2.0 * math.pi * i / nu
            v = 2.0 * math.pi * j / nv
            verts[i * nv + j] = ((R0 + r0 * math.cos(v)) * math.cos(u),
                                 r0 * math.sin(v) + r0 + 1.0,
                                 (R0 + r0 * math.cos(v)) * math.sin(u))
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces.append((a, c, b))
            faces.append((a, d, c))
    return verts, np.asarray(faces, np.int32)


def build(nu: int = 16, nv: int = 8) -> Desc:
    verts, faces = _torus(nu, nv)
    # the mesh's baked transform: scale 1, no rotation, translation (0, 0, 6)
    rot = np.eye(3, dtype=np.float32)
    pts = verts * 1.0 @ rot.T + np.asarray((0.0, 0.0, 6.0), np.float32)
    materials = (diffuse((0.75, 0.75, 0.75)), dielectric(1.5, 0.0),
                 diffuse((0.85, 0.25, 0.2)))
    spheres = ((0, 1000.0, (0.0, -1000.0, 0.0)), (1, 0.9, (-2.6, 0.9, 4.2)),
               (1, 0.9, (2.6, 0.9, 4.2)))
    lights = (square_area([3, 8, 2], [-0.4, -1.0, 0.3], 2.5,
                          [1.0, 1.0, 1.0], 6.0, 5000.0),)
    return Desc(materials, spheres, lights, tri_a=pts[faces[:, 0]],
                tri_b=pts[faces[:, 1]], tri_c=pts[faces[:, 2]],
                tri_mat=np.full((faces.shape[0],), 2, np.int32))
