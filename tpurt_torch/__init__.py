"""tpurt_torch: the PyTorch + CUDA port of tpurt for NVIDIA Hopper.

A progressive spectral path tracer with an SPPM photon pass. It imports
torch and NumPy, never JAX or tpurt; ``tpurt`` stays the reference the
port is held against. Its entry points build on the CUDA card unless the
caller passes ``device="cpu"``. The ported slice: sphere and mesh scenes
(OBJ/MTL loading, tpurt's mesh presets, triangle and sphere BVH walks)
with point and square area lights, diffuse/dielectric/metal/emissive
materials, the sky and the radiance clamp, the BVH knobs, tpurt's sampler
(hero wavelengths with the dispersive collapse, photon emission and
bounce strata, camera bounce strata), its camera-spawn extensions (the
Owen-scrambled Sobol spawn ``qmc``, the thin lens ``aperture``/
``focus_dist``, the shutter ``motion_blur`` with a ``MotionCamera``),
``photon_rr_scale`` and its presets (``RenderConfig.preset``);
``backend="pallas"`` (the regen kernel, CUDA on the card; with
``pallas_regen=False`` the tile-synchronized kernel),
``backend="xla"`` (the eager-torch integrator), the three wavefront
backends (``"wavefront"``, ``"wavefront_pallas"`` with the sweep kernel,
``"wavefront_fused"`` with the fused kernel) and adaptive sampling
(``render_adaptive``; on ``"pallas"`` through the regen kernel's budget
mode).
"""

from tpurt_torch.adaptive import render_adaptive, wavefront_render_budget
from tpurt_torch.camera import (Camera, CameraController, MotionCamera,
                                base_camera, make_camera, set_vfov)
from tpurt_torch.config import RenderConfig
from tpurt_torch.render import (RenderState, init_state, load_checkpoint,
                                render, render_step, resolve_image,
                                resolve_radiance, save_checkpoint)
from tpurt_torch.scene import (Light, Material, MeshData, Scene, Sphere,
                               build_scene, cornell_spheres_scene,
                               default_scene, dispersive_scene,
                               instanced_scene, many_light_scene,
                               torus_field_scene, torus_mesh_scene,
                               tri_test_scene)
from tpurt_torch.wavefront import WavefrontPool, wavefront_render

__all__ = [
    "Camera", "CameraController", "Light", "Material", "MeshData", "MotionCamera", "RenderConfig",
    "RenderState", "Scene", "Sphere", "WavefrontPool", "base_camera",
    "build_scene",
    "cornell_spheres_scene", "default_scene", "dispersive_scene",
    "init_state", "instanced_scene", "load_checkpoint", "make_camera",
    "many_light_scene", "render", "render_adaptive", "render_step",
    "resolve_image", "resolve_radiance", "save_checkpoint",
    "set_vfov", "torus_field_scene", "torus_mesh_scene", "tri_test_scene",
    "wavefront_render", "wavefront_render_budget",
]
