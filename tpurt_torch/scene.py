"""Scenes of the port: host description objects, the tensor ``Scene``, the
stock scenes, and ``freeze_scene``.

Follows ``tpurt.scene`` for spheres and lights (same construction API, same
array packing, same stock scenes). Meshes are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Material:
    """Type 0 diffuse, 1 dielectric, 2 metal (GGX conductor, color = F0),
    3 emissive (not in the ported slice)."""
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


@dataclasses.dataclass(frozen=True)
class Scene:
    """Sphere and light arrays (the sphere/light fields of tpurt.Scene)."""
    sph_center: torch.Tensor       # (S, 3) f32
    sph_radius: torch.Tensor       # (S,)   f32, 0 marks padding
    sph_mat: torch.Tensor          # (S,)   i32
    sph_mtype: torch.Tensor        # (S,)   i32, resolved material type
    sph_ior: torch.Tensor          # (S,)   f32, resolved base IOR
    mat_color: torch.Tensor        # (M, 3) f32
    mat_rough: torch.Tensor        # (M,)   f32
    mat_ior: torch.Tensor          # (M,)   f32
    mat_type: torch.Tensor         # (M,)   i32
    light_pos: torch.Tensor        # (L, 3) f32
    light_hw: torch.Tensor         # (L,)   f32, half width (area lights)
    light_color: torch.Tensor      # (L, 3) f32
    light_intensity: torch.Tensor  # (L,)   f32
    light_temp: torch.Tensor       # (L,)   f32, blackbody K; <= 0 is flat
    light_type: torch.Tensor       # (L,)   i32
    light_normal: torch.Tensor     # (L, 3) f32

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sph_center.device

    def to(self, device) -> "Scene":
        return Scene(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(Scene)})


def scene_from_arrays(arrays: dict) -> Scene:
    """Scene from NumPy arrays keyed by field name (float32/int32)."""
    return Scene(**{f.name: torch.from_numpy(np.ascontiguousarray(
        arrays[f.name])) for f in dataclasses.fields(Scene)})


def build_scene(materials: Sequence[Material], spheres: Sequence[Sphere] = (),
                meshes: Sequence = (), lights: Sequence[Light] = ()) -> Scene:
    """Pack description objects into a Scene (``tpurt.scene.build_scene``
    without meshes)."""
    if any(m.num_triangles() for m in meshes):
        raise NotImplementedError("meshes are not ported to tpurt_torch yet")
    materials = list(materials) or [Material.diffuse((0.8, 0.8, 0.8))]
    mat_type = np.array([m.mtype for m in materials], np.int32)
    mat_ior = np.array([m.ior for m in materials], np.float32)
    S, L = len(spheres), len(lights)
    sph_mat = np.array([q.material_id for q in spheres], np.int32)
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
    ))


def default_scene(obj_path: str | None = None) -> Scene:
    """The reference's default scene: ground, green and glass spheres, one
    5500 K square area light (the optional OBJ mesh is not ported)."""
    if obj_path is not None:
        raise NotImplementedError("meshes are not ported to tpurt_torch yet")
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
    lights = [Light.square_area([10.0, 3.0, 0.0], [-1.0, 0.0, 0.0], 3.0,
                                [1.0, 1.0, 1.0], 1.0, 5500.0)]
    return build_scene(materials, spheres, (), lights)


def cornell_spheres_scene() -> Scene:
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
    return build_scene(materials, spheres, (), lights)


def dispersive_scene() -> Scene:
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
    return build_scene(materials, spheres, (), lights)


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
class FrozenScene:
    spheres: tuple
    materials: tuple
    lights: tuple


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
    and photon cone frames. The scene description is read to the host once
    per render call; no pixel data moves."""
    h = {f.name: getattr(scene, f.name).detach().cpu().numpy()
         for f in dataclasses.fields(Scene)}
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
    if any(m.mtype not in (0, 1, 2) for m in materials):
        raise NotImplementedError(
            "emissive materials (type 3) are not ported to tpurt_torch yet")
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
    return FrozenScene(spheres=spheres, materials=materials,
                       lights=tuple(lights))


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
