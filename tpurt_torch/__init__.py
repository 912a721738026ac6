"""tpurt_torch: the PyTorch + CUDA port of tpurt for NVIDIA Hopper.

A progressive spectral path tracer with an SPPM photon pass. It imports
torch and NumPy, never JAX or tpurt; ``tpurt`` stays the reference the
port is held against. The ported slice: sphere and mesh scenes (OBJ/MTL
loading, tpurt's mesh presets, triangle and sphere BVH walks) with point
and square area lights, diffuse/dielectric/metal materials, default flags
and the BVH knobs,
``backend="pallas"`` (the regen kernel, CUDA on the card),
``backend="xla"`` (the eager-torch integrator), the three wavefront
backends (``"wavefront"``, ``"wavefront_pallas"`` with the sweep kernel,
``"wavefront_fused"`` with the fused kernel) and wavefront adaptive
sampling (``render_adaptive``).
"""

from tpurt_torch.adaptive import render_adaptive, wavefront_render_budget
from tpurt_torch.camera import Camera, make_camera
from tpurt_torch.config import RenderConfig
from tpurt_torch.render import (RenderState, init_state, load_checkpoint,
                                render, render_step, resolve_image,
                                resolve_radiance, save_checkpoint)
from tpurt_torch.scene import (Light, Material, MeshData, Scene, Sphere,
                               build_scene, cornell_spheres_scene,
                               default_scene, dispersive_scene,
                               instanced_scene, torus_field_scene,
                               torus_mesh_scene, tri_test_scene)
from tpurt_torch.wavefront import WavefrontPool, wavefront_render

__all__ = [
    "Camera", "Light", "Material", "MeshData", "RenderConfig",
    "RenderState", "Scene", "Sphere", "WavefrontPool", "build_scene",
    "cornell_spheres_scene", "default_scene", "dispersive_scene",
    "init_state", "instanced_scene", "load_checkpoint", "make_camera",
    "render", "render_adaptive", "render_step", "resolve_image",
    "resolve_radiance", "save_checkpoint", "torus_field_scene",
    "torus_mesh_scene", "tri_test_scene", "wavefront_render",
    "wavefront_render_budget",
]
