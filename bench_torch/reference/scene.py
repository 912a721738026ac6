"""The benchmark's scenes as the plain reference builds them, apart from
the program: the constructors of a scene's description (materials, lights,
``Desc``), in which each twin under ``scenes/`` copies a preset of the
port's (``tpurt_torch/scene.py``); the description packed into float32
arrays as the port's ``build_scene`` packs it (triangles in the leaf order
of its median-split BVH, which decides ties between equally near
triangles) and frozen into host constants as its ``freeze_scene`` does.
``scenes.twin`` finds a configuration's twin by its builder's name;
``BUILDERS`` is each twin's ``build`` by that name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench_torch.reference import fmath
from bench_torch.reference.scenes import Builders

EPS = 1e-5
PHOTON_CONE_COS = 0.707     # a point light emits photons in this cone


@dataclasses.dataclass(frozen=True)
class Material:
    color: tuple
    roughness: float
    ior: float
    mtype: int      # 0 diffuse, 1 dielectric, 2 metal, 3 emissive


def diffuse(color, roughness: float = 0.0) -> Material:
    return Material(tuple(color), roughness, 1.0, 0)


def dielectric(ior: float, roughness: float) -> Material:
    return Material((0.0, 0.0, 0.0), roughness, ior, 1)


def metal(f0_color, roughness: float = 0.0) -> Material:
    """A GGX conductor whose color is its F0."""
    return Material(tuple(f0_color), roughness, 1.0, 2)


@dataclasses.dataclass(frozen=True)
class Light:
    position: tuple
    color: tuple
    intensity: float
    color_temp: float
    ltype: int      # 0 point, 1 square area
    half_width: float
    normal: tuple


def point(position, color, intensity, color_temp=0.0) -> Light:
    """A point light (half width 0, the port's default normal)."""
    return Light(tuple(position), tuple(color), intensity, color_temp, 0,
                 0.0, (0.0, -1.0, 0.0))


def square_area(center, normal, half_width, color, intensity,
                color_temp=0.0) -> Light:
    """A square area light; its normal is normalized and forced down."""
    n = np.asarray(normal, np.float64)
    ln = np.linalg.norm(n)
    n = n / ln if ln > 0 else np.array([0.0, -1.0, 0.0])
    if n[1] > 0:
        n = -n
    return Light(tuple(center), tuple(color), intensity, color_temp, 1,
                 half_width, tuple(n))


@dataclasses.dataclass(frozen=True)
class Desc:
    """A scene before packing: spheres are (material, radius, center)."""
    materials: tuple
    spheres: tuple
    lights: tuple
    tri_a: np.ndarray       # (T, 3) f32 vertices of every triangle
    tri_b: np.ndarray
    tri_c: np.ndarray
    tri_mat: np.ndarray     # (T,) i32


def no_triangles() -> dict:
    """The triangle fields of a ``Desc`` of spheres only."""
    z = np.zeros((0, 3), np.float32)
    return dict(tri_a=z, tri_b=z, tri_c=z,
                tri_mat=np.zeros((0,), np.int32))


BUILDERS = Builders()


def leaf_order(tri_min: np.ndarray, tri_max: np.ndarray,
               max_prims: int = 2) -> np.ndarray:
    """The triangles' order in the leaves of the median-split BVH: split
    the longest centroid axis (x wins ties with y and z, y with z) at the
    median of a stable sort, left subtree first."""
    T = tri_min.shape[0]
    centroid = 0.5 * tri_min + 0.5 * tri_max
    order: list[int] = []
    stack = [np.arange(T, dtype=np.int64)]
    while stack:
        idx = stack.pop()
        n = len(idx)
        if n <= max_prims:
            order.extend(idx.tolist())
            continue
        c = centroid[idx]
        d = c.max(axis=0) - c.min(axis=0)
        if d[0] >= d[1] and d[0] >= d[2]:
            dim = 0
        elif d[1] >= d[2]:
            dim = 1
        else:
            dim = 2
        srt = idx[np.argsort(c[:, dim], kind="stable")]
        stack.append(srt[n // 2:])
        stack.append(srt[:n // 2])
    return np.asarray(order, np.int64)


def _f32(x) -> float:
    """A host double rounded once to float32."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class FSphere:
    c: tuple
    r: float
    r2: float       # f32(r*r) from the double product
    mat: int
    mtype: int
    ior: float


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
    cone_axis: tuple    # normalize(origin - pos): a point light's cone
    cone_t: tuple
    cone_b: tuple
    two_hw: float       # f32(2 hw)
    area_scale: float   # f32(max(4 hw^2, 1e-10))
    em_scale: tuple     # f32(color * intensity * range)
    ph_origin: tuple    # f32(pos + normal * EPS)


@dataclasses.dataclass(frozen=True)
class FTriangles:
    """Row i is scene index i: ties go to the lower index."""
    a: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n: torch.Tensor
    mat: torch.Tensor

    @property
    def count(self) -> int:
        return self.a.shape[0]


@dataclasses.dataclass(frozen=True)
class FrozenScene:
    spheres: tuple
    materials: tuple
    lights: tuple
    triangles: FTriangles | None
    cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)


def _tangent_frame_np(n):
    n = np.asarray(n, np.float32)
    if abs(float(n[1])) > 0.99999:
        t = np.array([1.0, 0.0, 0.0], np.float32)
    else:
        t = np.array([n[2], 0.0, -n[0]], np.float32)
        t = t / np.sqrt(max(float(t @ t), 1e-30))
    b = np.cross(n, t)
    return tuple(float(x) for x in t), tuple(float(x) for x in b)


def freeze(desc: Desc, device) -> FrozenScene:
    """The scene as host constants and triangle tensors on ``device`` in
    the reference's precision, each value through float32 first."""
    def tup(v):
        return tuple(float(x) for x in np.asarray(v, np.float32))
    mats = desc.materials
    spheres = tuple(
        FSphere(c=tup(c), r=float(np.float32(r)),
                r2=_f32(float(np.float32(r)) * float(np.float32(r))),
                mat=m, mtype=mats[m].mtype, ior=float(np.float32(mats[m].ior)))
        for m, r, c in desc.spheres if float(np.float32(r)) > 0.0)
    materials = tuple(FMaterial(color=tup(m.color),
                                rough=float(np.float32(m.roughness)),
                                ior=float(np.float32(m.ior)), mtype=m.mtype)
                      for m in mats)
    lights = []
    for lt in desc.lights:
        normal = tup(lt.normal)
        tangent, bitangent = _tangent_frame_np(normal)
        pos = tup(lt.position)
        axis = -np.asarray(pos, np.float32)
        axis = axis / np.sqrt(max(float(axis @ axis), 1e-30))
        cone_t, cone_b = _tangent_frame_np(axis)
        hw = float(np.float32(lt.half_width))
        color = tup(lt.color)
        intensity = float(np.float32(lt.intensity))
        lights.append(FLight(
            pos=pos, hw=hw, color=color, intensity=intensity,
            temp=float(np.float32(lt.color_temp)), ltype=lt.ltype,
            normal=normal, tangent=tangent, bitangent=bitangent,
            cone_axis=tuple(float(x) for x in axis), cone_t=cone_t,
            cone_b=cone_b, two_hw=_f32(2.0 * hw),
            area_scale=_f32(max(4.0 * hw * hw, 1e-10)),
            em_scale=tuple(_f32(color[c] * intensity * 400.0)
                           for c in range(3)),
            ph_origin=tuple(_f32(pos[c] + normal[c] * EPS) for c in range(3))))
    tris = None
    if desc.tri_a.shape[0]:
        A, B, C = desc.tri_a, desc.tri_b, desc.tri_c
        e1, e2 = B - A, C - A
        n = np.cross(e1, e2)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        perm = leaf_order(np.minimum(np.minimum(A, B), C),
                          np.maximum(np.maximum(A, B), C))
        t = lambda x: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(x[perm], np.float32)).to(device, fmath.F)
        tris = FTriangles(a=t(A), e1=t(e1), e2=t(e2), n=t(n),
                          mat=torch.from_numpy(np.ascontiguousarray(
                              desc.tri_mat[perm], np.int32)).to(device))
    return FrozenScene(spheres=spheres, materials=materials,
                       lights=tuple(lights), triangles=tris)


def photon_power(light: FLight, k_photons: int) -> tuple:
    """Initial photon throughput: the light's power over K, times the
    cone's solid-angle fraction for a point light (f32 of the double
    expression)."""
    cf = (1.0 - PHOTON_CONE_COS) * 0.5
    if light.ltype == 0:
        return tuple(_f32(light.color[c] * light.intensity / k_photons * cf)
                     for c in range(3))
    return tuple(_f32(light.color[c] * light.intensity / k_photons)
                 for c in range(3))
