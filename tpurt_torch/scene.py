"""Scenes of the port: host description objects, the tensor ``Scene``, the
stock scenes, and ``freeze_scene``.

Follows ``tpurt.scene``: the same construction API, the same array packing
(triangles of every mesh merged, a BVH built on the host, the triangle
arrays permuted into its leaf order) and the same stock scenes, array for
array (tests/test_torch_scene.py, tests/test_torch_mesh.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from tpurt_torch import accel
from tpurt_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Material:
    """Type 0 diffuse, 1 dielectric, 2 metal (GGX conductor, color = F0),
    3 emissive (color = the emitted color times its intensity)."""
    color: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.0
    ior: float = 1.0
    mtype: int = 0

    @staticmethod
    def diffuse(color, roughness: float = 0.0) -> "Material":
        return Material(color=tuple(color), roughness=roughness, ior=1.0,
                        mtype=0)

    @staticmethod
    def dielectric(ior: float, roughness: float) -> "Material":
        return Material(color=(0.0, 0.0, 0.0), roughness=roughness, ior=ior,
                        mtype=1)

    @staticmethod
    def metal(f0_color, roughness: float = 0.0) -> "Material":
        return Material(color=tuple(f0_color), roughness=roughness, ior=1.0,
                        mtype=2)

    @staticmethod
    def emissive(color, intensity: float = 1.0) -> "Material":
        """Type-3 emitter (``tpurt.scene.Material.emissive``): a camera
        path that hits it adds color * intensity * cie_rgb(lambda) * range
        and ends, a photon that hits it is absorbed, a shadow ray sees an
        occluder. Next-event estimation does not sample it."""
        return Material(color=tuple(float(intensity) * c for c in color),
                        roughness=0.0, ior=1.0, mtype=3)


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Unit sphere scaled to `scale` at `translation` (rotation is kept for
    API parity and has no effect on a sphere)."""
    material_id: int
    scale: float
    translation: tuple
    rotation_deg: float = 0.0

    @property
    def center(self):
        return np.asarray(self.translation, np.float32)


@dataclasses.dataclass(frozen=True)
class Light:
    """Type 0 point, 1 square area (normal forced downward)."""
    position: tuple
    color: tuple
    intensity: float
    color_temp: float
    ltype: int
    half_width: float = 0.0
    normal: tuple = (0.0, -1.0, 0.0)

    @staticmethod
    def point(position, color, intensity, color_temp=0.0) -> "Light":
        return Light(tuple(position), tuple(color), intensity, color_temp,
                     ltype=0)

    @staticmethod
    def square_area(center, normal, half_width, color, intensity,
                    color_temp=0.0) -> "Light":
        n = np.asarray(normal, np.float64)
        ln = np.linalg.norm(n)
        n = n / ln if ln > 0 else np.array([0.0, -1.0, 0.0])
        if n[1] > 0:
            n = -n
        return Light(tuple(center), tuple(color), intensity, color_temp,
                     ltype=1, half_width=half_width, normal=tuple(n))


class MeshData:
    """Host triangle soup with a baked T*R*S transform (rotation about +Y,
    as in the reference's src/instance.rs:35-124)."""

    def __init__(self, material_id: int = 0, translation=(0.0, 0.0, 0.0),
                 rotation_deg: float = 0.0, scale: float = 1.0):
        self.material_id = material_id
        self.translation = np.asarray(translation, np.float32)
        self.rotation_deg = float(rotation_deg)
        self.scale = float(scale)
        self.positions = np.zeros((0, 3), np.float32)
        self.indices = np.zeros((0, 3), np.int32)
        self.tri_material = np.zeros((0,), np.int32)

    def _xform(self, pts: np.ndarray) -> np.ndarray:
        th = math.radians(self.rotation_deg)
        c, s = math.cos(th), math.sin(th)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        return pts * self.scale @ rot.T + self.translation

    def add_triangles(self, positions: np.ndarray, indices: np.ndarray,
                      tri_material: np.ndarray | None = None):
        """Append raw triangles, positions transformed by the baked TRS;
        ``tri_material`` (T,) overrides the mesh-wide material per face."""
        base = self.positions.shape[0]
        self.positions = np.concatenate(
            [self.positions, self._xform(np.asarray(positions, np.float32))])
        idx = np.asarray(indices, np.int32) + base
        self.indices = np.concatenate([self.indices, idx])
        if tri_material is None:
            tri_material = np.full((idx.shape[0],), self.material_id,
                                   np.int32)
        else:
            tri_material = np.asarray(tri_material, np.int32)
            if tri_material.shape != (idx.shape[0],):
                raise ValueError(f"tri_material shape {tri_material.shape} "
                                 f"!= ({idx.shape[0]},)")
        self.tri_material = np.concatenate([self.tri_material, tri_material])

    def load_obj(self, path: str, materials: list | None = None):
        """Load an OBJ file into this mesh. With ``materials`` (a mutable
        list of Material) ``mtllib``/``usemtl`` are honoured: each named MTL
        material is appended to ``materials`` and its faces get its id;
        other faces keep this mesh's material_id."""
        from tpurt_torch.utils import obj
        if materials is None:
            positions, indices = obj.parse_obj(path)
            self.add_triangles(positions, indices)
        else:
            positions, indices, tri_slot, slot_names, mtl_defs = \
                obj.parse_obj_mtl(path)
            slot_to_id = np.full((len(slot_names),), self.material_id,
                                 np.int32)
            for slot, name in enumerate(slot_names):
                if name is not None and name in mtl_defs:
                    slot_to_id[slot] = len(materials)
                    materials.append(obj.mtl_to_material(mtl_defs[name]))
            self.add_triangles(positions, indices,
                               tri_material=slot_to_id[tri_slot]
                               if indices.shape[0] else None)
        print(f"Loading model: {path} ({indices.shape[0]} triangles)")

    def num_triangles(self) -> int:
        return self.indices.shape[0]


@dataclasses.dataclass(frozen=True)
class Scene:
    """The fields of tpurt.Scene, as tensors on one device. What is
    derived from it (``freeze_scene`` and, through that, the kernels'
    tables) is built once per Scene object and cached on it: treat its
    tensors as read-only."""
    sph_center: torch.Tensor       # (S, 3) f32
    sph_radius: torch.Tensor       # (S,)   f32, 0 marks padding
    sph_mat: torch.Tensor          # (S,)   i32
    sph_mtype: torch.Tensor        # (S,)   i32, resolved material type
    sph_ior: torch.Tensor          # (S,)   f32, resolved base IOR
    mat_color: torch.Tensor        # (M, 3) f32
    mat_rough: torch.Tensor        # (M,)   f32
    mat_ior: torch.Tensor          # (M,)   f32
    mat_type: torch.Tensor         # (M,)   i32
    tri_a: torch.Tensor            # (T, 3) f32, BVH leaf order
    tri_e1: torch.Tensor           # (T, 3) f32
    tri_e2: torch.Tensor           # (T, 3) f32
    tri_n: torch.Tensor            # (T, 3) f32, unit geometric normal
    tri_mat: torch.Tensor          # (T,)   i32
    bvh_min: torch.Tensor          # (B, 3) f32, leaf ranges index tri_*
    bvh_max: torch.Tensor          # (B, 3) f32
    bvh_left: torch.Tensor         # (B,)   i32
    bvh_right: torch.Tensor        # (B,)   i32
    bvh_first: torch.Tensor        # (B,)   i32
    bvh_count: torch.Tensor        # (B,)   i32
    light_pos: torch.Tensor        # (L, 3) f32
    light_hw: torch.Tensor         # (L,)   f32, half width (area lights)
    light_color: torch.Tensor      # (L, 3) f32
    light_intensity: torch.Tensor  # (L,)   f32
    light_temp: torch.Tensor       # (L,)   f32, blackbody K; <= 0 is flat
    light_type: torch.Tensor       # (L,)   i32
    light_normal: torch.Tensor     # (L, 3) f32
    bvh_max_leaf: torch.Tensor     # ()     i64, the build-time leaf capacity

    def __post_init__(self):
        # what is derived from this scene (freeze_scene)
        object.__setattr__(self, "cache", {})

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_a.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sph_center.device

    def tensors(self) -> dict:
        """The fields by name."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(Scene)}

    def to(self, device) -> "Scene":
        return Scene(**{k: v.to(device) for k, v in self.tensors().items()})


def scene_from_arrays(arrays: dict, device=None) -> Scene:
    """Scene on ``device`` (the CUDA card by default) from NumPy arrays
    keyed by field name (float32/int32, and an int64 scalar
    ``bvh_max_leaf``)."""
    dev = resolve_device(device)
    return Scene(**{f.name: torch.from_numpy(np.ascontiguousarray(
        arrays[f.name])).to(dev) for f in dataclasses.fields(Scene)})


def _merge_meshes(meshes):
    """Vertices a, b, c (T, 3) and materials (T,) of every mesh, merged."""
    parts = [(m.positions[m.indices[:, 0]], m.positions[m.indices[:, 1]],
              m.positions[m.indices[:, 2]], m.tri_material)
             for m in meshes if m.num_triangles()]
    if not parts:
        z = np.zeros((0, 3), np.float32)
        return z, z, z, np.zeros((0,), np.int32)
    return tuple(np.concatenate(p) for p in zip(*parts))


def build_scene(materials: Sequence[Material], spheres: Sequence[Sphere] = (),
                meshes: Sequence[MeshData] = (), lights: Sequence[Light] = (),
                max_leaf_prims: int = 2, device=None) -> Scene:
    """Pack description objects into a Scene (``tpurt.scene.build_scene``):
    the triangles of every mesh merged, a median-split BVH with leaves of
    at most ``max_leaf_prims`` triangles, the triangle arrays permuted into
    its leaf order. The tensors go to ``device``, the CUDA card unless the
    caller asks for another (``device="cpu"``); so do the presets'."""
    dev = resolve_device(device)
    materials = list(materials) or [Material.diffuse((0.8, 0.8, 0.8))]
    mat_type = np.array([m.mtype for m in materials], np.int32)
    mat_ior = np.array([m.ior for m in materials], np.float32)
    S, L = len(spheres), len(lights)
    sph_mat = np.array([q.material_id for q in spheres], np.int32)

    A, Bv, C, Mt = _merge_meshes(meshes)
    e1 = Bv - A
    e2 = C - A
    n = np.cross(e1, e2)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    bvh = accel.build_bvh(np.minimum(np.minimum(A, Bv), C),
                          np.maximum(np.maximum(A, Bv), C), max_leaf_prims)
    if A.shape[0] > 0:
        perm = bvh.order
        A, e1, e2, n, Mt = A[perm], e1[perm], e2[perm], n[perm], Mt[perm]
    return scene_from_arrays(dict(
        sph_center=np.array([q.center for q in spheres],
                            np.float32).reshape(S, 3),
        sph_radius=np.array([q.scale for q in spheres], np.float32),
        sph_mat=sph_mat,
        sph_mtype=mat_type[sph_mat] if S else np.zeros((0,), np.int32),
        sph_ior=mat_ior[sph_mat] if S else np.zeros((0,), np.float32),
        mat_color=np.array([m.color for m in materials],
                           np.float32).reshape(-1, 3),
        mat_rough=np.array([m.roughness for m in materials], np.float32),
        mat_ior=mat_ior,
        mat_type=mat_type,
        tri_a=A.astype(np.float32), tri_e1=e1.astype(np.float32),
        tri_e2=e2.astype(np.float32), tri_n=n.astype(np.float32),
        tri_mat=np.asarray(Mt, np.int32),
        bvh_min=bvh.bbox_min, bvh_max=bvh.bbox_max, bvh_left=bvh.left,
        bvh_right=bvh.right, bvh_first=bvh.first, bvh_count=bvh.count,
        bvh_max_leaf=np.asarray(
            max(max_leaf_prims, int(bvh.count.max(initial=0))), np.int64),
        light_pos=np.array([q.position for q in lights],
                           np.float32).reshape(L, 3),
        light_hw=np.array([q.half_width for q in lights], np.float32),
        light_color=np.array([q.color for q in lights],
                             np.float32).reshape(L, 3),
        light_intensity=np.array([q.intensity for q in lights], np.float32),
        light_temp=np.array([q.color_temp for q in lights], np.float32),
        light_type=np.array([q.ltype for q in lights], np.int32),
        light_normal=np.array([q.normal for q in lights],
                              np.float32).reshape(L, 3),
    ), dev)


def default_scene(obj_path: str | None = None, device=None) -> Scene:
    """The reference's default scene: ground, green and glass spheres, an
    optional red OBJ mesh at (0, 3, 5) scale 0.5, one 5500 K square area
    light."""
    materials = [
        Material.diffuse((0.8, 0.8, 0.8)),
        Material.diffuse((0.2, 0.85, 0.2)),
        Material.dielectric(1.5, 0.01),
        Material.diffuse((0.85, 0.2, 0.2)),
    ]
    spheres = [
        Sphere(1, 1.0, (0.0, 1.0, -1.0)),
        Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
        Sphere(2, 1.0, (0.0, 1.0, 1.0)),
    ]
    meshes = []
    if obj_path is not None:
        mesh = MeshData(material_id=3, translation=(0.0, 3.0, 5.0), scale=0.5)
        mesh.load_obj(obj_path)
        meshes.append(mesh)
    lights = [Light.square_area([10.0, 3.0, 0.0], [-1.0, 0.0, 0.0], 3.0,
                                [1.0, 1.0, 1.0], 1.0, 5500.0)]
    return build_scene(materials, spheres, meshes, lights, max_leaf_prims=2,
                       device=device)


def cornell_spheres_scene(device=None) -> Scene:
    """Cornell box of giant-sphere walls with glass, frosted and white
    balls and one square area light (the headline benchmark scene)."""
    materials = [
        Material.diffuse((0.73, 0.73, 0.73)),   # white
        Material.diffuse((0.65, 0.05, 0.05)),   # red
        Material.diffuse((0.12, 0.45, 0.15)),   # green
        Material.dielectric(1.5, 0.0),          # glass
        Material.dielectric(1.5, 0.04),         # frosted
    ]
    R = 1000.0
    box = 5.0
    spheres = [
        Sphere(0, R, (0.0, -R, 0.0)),          # floor
        Sphere(0, R, (0.0, R + 2 * box, 0.0)), # ceiling
        Sphere(0, R, (0.0, box, R + box)),     # back
        Sphere(1, R, (-R - box, box, 0.0)),    # left (red)
        Sphere(2, R, (R + box, box, 0.0)),     # right (green)
        Sphere(3, 1.5, (-1.8, 1.5, 1.0)),      # glass ball
        Sphere(4, 1.5, (1.8, 1.5, -0.5)),      # frosted ball
        Sphere(0, 1.0, (0.3, 1.0, 2.8)),       # small white
    ]
    lights = [Light.square_area([0.0, 2 * box - 0.01, 0.0], [0.0, -1.0, 0.0],
                                1.5, [1.0, 1.0, 1.0], 6.0, 5500.0)]
    return build_scene(materials, spheres, (), lights, device=device)


def dispersive_scene(device=None) -> Scene:
    """Dispersive crown and flint glass, brushed gold and two diffuse
    materials, lit by a 5500 K point light and a 3200 K square light (the
    scene of tpurt's bench configs 4 and 5)."""
    materials = [
        Material.diffuse((0.8, 0.8, 0.8)),
        Material.dielectric(1.52, 0.0),    # crown-glass ball (dispersive)
        Material.dielectric(1.72, 0.0),    # dense flint
        Material.metal((1.0, 0.71, 0.29), 0.05),  # brushed gold
        Material.diffuse((0.3, 0.3, 0.8)),
    ]
    spheres = [
        Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
        Sphere(1, 1.0, (-2.2, 1.0, 4.0)),
        Sphere(2, 1.0, (0.0, 1.0, 4.5)),
        Sphere(3, 1.0, (2.2, 1.0, 4.0)),
        Sphere(4, 0.7, (0.0, 0.7, 7.0)),
    ]
    lights = [
        Light.point([0.0, 8.0, 0.0], [1.0, 1.0, 1.0], 60.0, 5500.0),
        Light.square_area([6.0, 4.0, 4.0], [-1.0, -0.3, 0.0], 2.0,
                          [1.0, 1.0, 1.0], 4.0, 3200.0),
    ]
    return build_scene(materials, spheres, (), lights, device=device)


def instanced_scene(n_instances: int = 256, seed: int = 7,
                    device=None) -> Scene:
    """``n_instances`` spheres of random size and material on a ground
    sphere, under one 6500 K square light (tpurt's bench configs 3 and 8)."""
    rng = np.random.default_rng(seed)
    materials = [
        Material.diffuse((0.75, 0.75, 0.75)),
        Material.diffuse((0.8, 0.3, 0.25)),
        Material.diffuse((0.25, 0.5, 0.85)),
        Material.dielectric(1.5, 0.0),
        Material.dielectric(1.5, 0.05),
        Material.diffuse((0.9, 0.75, 0.3)),
    ]
    spheres = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0))]
    side = int(math.ceil(math.sqrt(n_instances)))
    for i in range(n_instances):
        gx, gz = i % side, i // side
        x = (gx - side / 2) * 2.2 + rng.uniform(-0.4, 0.4)
        z = (gz - side / 2) * 2.2 + rng.uniform(-0.4, 0.4) + 8.0
        r = rng.uniform(0.3, 0.8)
        mat = int(rng.integers(1, len(materials)))
        spheres.append(Sphere(mat, r, (x, r, z)))
    lights = [Light.square_area([0.0, 30.0, 8.0], [0.0, -1.0, 0.0], 8.0,
                                [1.0, 1.0, 1.0], 40.0, 6500.0)]
    return build_scene(materials, spheres, [], lights, device=device)


def many_light_scene(n_lights: int = 16, seed: int = 11,
                     device=None) -> Scene:
    """Cornell-style room lit by a grid of ``n_lights`` small area lights
    of very unequal power, with two sphere props (tpurt's many-light
    stress scene). Under light_sample "all" next-event estimation goes
    over every light, so its cost grows with ``n_lights`` ("power" and
    "spatial" trace one shadow segment a hit); past the kernels'
    shared-memory budget the light rows are read from global memory."""
    rng = np.random.default_rng(seed)
    materials = [
        Material.diffuse((0.73, 0.73, 0.73)),
        Material.diffuse((0.65, 0.05, 0.05)),
        Material.diffuse((0.12, 0.45, 0.15)),
        Material.dielectric(1.5, 0.0),
    ]
    R = 1000.0
    box = 5.0
    spheres = [
        Sphere(0, R, (0.0, -R, 0.0)),
        Sphere(0, R, (0.0, R + 2 * box, 0.0)),
        Sphere(0, R, (0.0, box, R + box)),
        Sphere(1, R, (-R - box, box, 0.0)),
        Sphere(2, R, (R + box, box, 0.0)),
        Sphere(3, 1.5, (-1.8, 1.5, 1.0)),
        Sphere(0, 1.2, (1.8, 1.2, -0.5)),
    ]
    side = int(math.ceil(math.sqrt(n_lights)))
    lights = []
    for i in range(n_lights):
        gx, gz = i % side, i // side
        x = (gx + 0.5) / side * 2 * (box - 0.5) - (box - 0.5)
        z = (gz + 0.5) / side * 2 * (box - 0.5) - (box - 0.5)
        # log-uniform power spread
        inten = float(10.0 ** rng.uniform(-1.0, 1.0))
        col = tuple(float(c) for c in rng.uniform(0.3, 1.0, 3))
        lights.append(Light.square_area(
            [x, 2 * box - 0.01, z], [0.0, -1.0, 0.0],
            float(rng.uniform(0.2, 0.6)), col, inten,
            float(rng.uniform(2500.0, 6500.0))))
    return build_scene(materials, spheres, (), lights, device=device)


def _torus(nu: int, nv: int):
    """The 2*nu*nv-triangle torus of tpurt's mesh presets, outward
    winding: vertices (nu*nv, 3) and faces (2*nu*nv, 3)."""
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


def torus_mesh_scene(nu: int = 16, nv: int = 8, device=None) -> Scene:
    """A 2*nu*nv-triangle torus mesh and two glass spheres on a ground
    sphere under one 5000 K square light (tpurt's bench config 6 at
    (45, 45): 4050 triangles)."""
    verts, faces = _torus(nu, nv)
    mesh = MeshData(material_id=2, translation=(0.0, 0.0, 6.0))
    mesh.add_triangles(verts, faces)
    materials = [
        Material.diffuse((0.75, 0.75, 0.75)),
        Material.dielectric(1.5, 0.0),
        Material.diffuse((0.85, 0.25, 0.2)),
    ]
    spheres = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
               Sphere(1, 0.9, (-2.6, 0.9, 4.2)),
               Sphere(1, 0.9, (2.6, 0.9, 4.2))]
    lights = [Light.square_area([3, 8, 2], [-0.4, -1.0, 0.3], 2.5,
                                [1.0, 1.0, 1.0], 6.0, 5000.0)]
    return build_scene(materials, spheres, [mesh], lights, device=device)


def torus_field_scene(n_tori: int = 16, nu: int = 45, nv: int = 45,
                      seed: int = 5, device=None) -> Scene:
    """``n_tori`` tori of 2*nu*nv triangles each, spread over the ground
    plane (64,800 triangles by default; tpurt's bench configs 7 and 9)."""
    rng = np.random.default_rng(seed)
    verts, faces = _torus(nu, nv)
    materials = [
        Material.diffuse((0.75, 0.75, 0.75)),
        Material.dielectric(1.5, 0.0),
        Material.diffuse((0.85, 0.25, 0.2)),
        Material.diffuse((0.25, 0.45, 0.8)),
        Material.metal((0.95, 0.75, 0.35), 0.05),
    ]
    meshes = []
    side = int(math.ceil(math.sqrt(n_tori)))
    for t in range(n_tori):
        gx, gz = t % side, t // side
        x = (gx - (side - 1) / 2) * 7.0 + rng.uniform(-1.0, 1.0)
        z = (gz - (side - 1) / 2) * 7.0 + 10.0 + rng.uniform(-1.0, 1.0)
        mesh = MeshData(material_id=int(rng.integers(2, len(materials))),
                        translation=(x, 0.0, z),
                        rotation_deg=float(rng.uniform(0.0, 360.0)))
        mesh.add_triangles(verts, faces)
        meshes.append(mesh)
    spheres = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
               Sphere(1, 0.9, (0.0, 0.9, 2.0))]
    lights = [Light.square_area([0, 22, 10], [0.0, -1.0, 0.0], 6.0,
                                [1.0, 1.0, 1.0], 25.0, 5500.0)]
    return build_scene(materials, spheres, meshes, lights, device=device)


def tri_test_scene(device=None) -> Scene:
    """A two-triangle quad over a ground sphere, one point light."""
    materials = [
        Material.diffuse((0.8, 0.8, 0.8)),
        Material.diffuse((0.85, 0.2, 0.2)),
    ]
    mesh = MeshData(material_id=1)
    quad_pos = np.array([
        [-1.0, 0.0, 3.0], [1.0, 0.0, 3.0], [1.0, 2.0, 3.0], [-1.0, 2.0, 3.0],
    ], np.float32)
    mesh.add_triangles(quad_pos, np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    spheres = [Sphere(0, 1000.0, (0.0, -1000.5, 0.0))]
    lights = [Light.point([0.0, 5.0, 0.0], [1.0, 1.0, 1.0], 10.0, 5500.0)]
    return build_scene(materials, spheres, [mesh], lights, device=device)


# ----- frozen scene: host constants for the integrator and the kernel -----

PHOTON_CONE_COS = 0.707
EPS = 1e-5


def _f32(x) -> float:
    """A host double rounded once to float32, as tpurt bakes constants."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class FSphere:
    c: tuple        # center
    r: float
    r2: float       # f32(r*r) from the double product
    mat: int
    mtype: int      # resolved material type (shadow pass)
    ior: float      # resolved base IOR (shadow pass)


@dataclasses.dataclass(frozen=True)
class FMaterial:
    color: tuple
    rough: float
    ior: float
    mtype: int


@dataclasses.dataclass(frozen=True)
class FLight:
    pos: tuple
    hw: float
    color: tuple
    intensity: float
    temp: float
    ltype: int
    normal: tuple
    tangent: tuple
    bitangent: tuple
    cone_axis: tuple    # normalize(origin - pos): point-light photon cone
    cone_t: tuple
    cone_b: tuple
    two_hw: float       # f32(2 hw): square sample extent
    area_scale: float   # f32(max(4 hw^2, 1e-10)): 1 / square pdf
    em_scale: tuple     # f32(color * intensity * range)
    ph_origin: tuple    # f32(pos + normal * EPS): area photon origin


@dataclasses.dataclass(frozen=True)
class FTriangles:
    """The scene's triangles as tensors on its device, by reference. Row i
    is scene index i: ties between equally near triangles go to the lower
    index."""
    a: torch.Tensor      # (T, 3) f32
    e1: torch.Tensor     # (T, 3) f32
    e2: torch.Tensor     # (T, 3) f32
    n: torch.Tensor      # (T, 3) f32
    mat: torch.Tensor    # (T,)   i32
    # the Scene's own BVH over these rows (the use_bvh walk): bvh_min,
    # bvh_max, bvh_left, bvh_right, bvh_first, bvh_count, and its leaf cap
    bvh: tuple = ()
    max_leaf: int = 0

    @property
    def count(self) -> int:
        return self.a.shape[0]


@dataclasses.dataclass(frozen=True)
class FrozenScene:
    spheres: tuple
    materials: tuple
    lights: tuple
    sph_rows: torch.Tensor                # sphere_rows(spheres), on device
    triangles: FTriangles | None = None   # None: no triangles
    # the kernels' tables of this scene, per knob set (kernels/bvh.py,
    # kernels/mega_regen.py)
    cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    @property
    def device(self) -> torch.device:
        return self.sph_rows.device


def sphere_rows(spheres) -> np.ndarray:
    """(S, 8) float32 rows cx cy cz r2 mat mtype ior index: the spheres as
    the kernels' tables and the chunked sweeps read them."""
    rows = np.zeros((len(spheres), 8), np.float32)
    for i, sp in enumerate(spheres):
        rows[i] = (*sp.c, sp.r2, sp.mat, sp.mtype, sp.ior, i)
    return rows


def _tangent_frame_np(n):
    """Host twin of soa.build_tangent_frame_c."""
    n = np.asarray(n, np.float32)
    if abs(float(n[1])) > 0.99999:
        t = np.array([1.0, 0.0, 0.0], np.float32)
    else:
        t = np.array([n[2], 0.0, -n[0]], np.float32)
        t = t / np.sqrt(max(float(t @ t), 1e-30))
    b = np.cross(n, t)
    return tuple(float(x) for x in t), tuple(float(x) for x in b)


def freeze_scene(scene: Scene) -> FrozenScene:
    """The scene as host constants (``tpurt.kernels.mega_pallas.
    freeze_scene``): drops r == 0 spheres, builds the light tangent frames
    and photon cone frames; the triangles stay tensors on the scene's
    device. Built once per Scene object and cached on it."""
    fs = scene.cache.get("frozen")
    if fs is None:
        fs = scene.cache["frozen"] = _freeze(scene)
    return fs


def _freeze(scene: Scene) -> FrozenScene:
    h = {k: v.detach().cpu().numpy() for k, v in scene.tensors().items()
         if k.startswith(("sph_", "mat_", "light_"))}
    tup = lambda v: tuple(float(x) for x in v)   # noqa: E731
    spheres = tuple(
        FSphere(c=tup(h["sph_center"][i]), r=float(h["sph_radius"][i]),
                r2=_f32(float(h["sph_radius"][i])
                        * float(h["sph_radius"][i])),
                mat=int(h["sph_mat"][i]), mtype=int(h["sph_mtype"][i]),
                ior=float(h["sph_ior"][i]))
        for i in range(h["sph_center"].shape[0])
        if float(h["sph_radius"][i]) > 0.0)
    materials = tuple(
        FMaterial(color=tup(h["mat_color"][i]),
                  rough=float(h["mat_rough"][i]),
                  ior=float(h["mat_ior"][i]), mtype=int(h["mat_type"][i]))
        for i in range(h["mat_color"].shape[0]))
    if any(m.mtype not in (0, 1, 2, 3) for m in materials):
        raise ValueError(f"material types are 0-3, got "
                         f"{sorted({m.mtype for m in materials})}")
    lights = []
    for j in range(h["light_pos"].shape[0]):
        ltype = int(h["light_type"][j])
        if ltype not in (0, 1):
            raise NotImplementedError(f"light type {ltype} is not supported")
        normal = tup(h["light_normal"][j])
        tangent, bitangent = _tangent_frame_np(normal)
        pos = tup(h["light_pos"][j])
        axis = -np.asarray(pos, np.float32)
        axis = axis / np.sqrt(max(float(axis @ axis), 1e-30))
        cone_t, cone_b = _tangent_frame_np(axis)
        hw = float(h["light_hw"][j])
        color = tup(h["light_color"][j])
        intensity = float(h["light_intensity"][j])
        lights.append(FLight(
            pos=pos, hw=hw, color=color, intensity=intensity,
            temp=float(h["light_temp"][j]), ltype=ltype,
            normal=normal, tangent=tangent, bitangent=bitangent,
            cone_axis=tup(axis), cone_t=cone_t, cone_b=cone_b,
            two_hw=_f32(2.0 * hw), area_scale=_f32(max(4.0 * hw * hw, 1e-10)),
            em_scale=tuple(_f32(color[c] * intensity * 400.0)
                           for c in range(3)),
            ph_origin=tuple(_f32(pos[c] + normal[c] * EPS) for c in range(3)),
        ))
    tris = None
    if scene.num_triangles:
        tris = FTriangles(a=scene.tri_a, e1=scene.tri_e1, e2=scene.tri_e2,
                          n=scene.tri_n, mat=scene.tri_mat,
                          bvh=(scene.bvh_min, scene.bvh_max, scene.bvh_left,
                               scene.bvh_right, scene.bvh_first,
                               scene.bvh_count),
                          max_leaf=int(scene.bvh_max_leaf))
    return FrozenScene(
        spheres=spheres, materials=materials, lights=tuple(lights),
        sph_rows=torch.from_numpy(sphere_rows(spheres)).to(scene.device),
        triangles=tris)


def photon_power(light: FLight, k_photons: int) -> tuple:
    """Initial photon throughput of ``light``: its power over K, times the
    cone's solid-angle fraction for a point light (f32 of the double
    expression, as tpurt's kernels bake it)."""
    cf = (1.0 - PHOTON_CONE_COS) * 0.5
    if light.ltype == 0:
        return tuple(_f32(light.color[c] * light.intensity / k_photons * cf)
                     for c in range(3))
    return tuple(_f32(light.color[c] * light.intensity / k_photons)
                 for c in range(3))
