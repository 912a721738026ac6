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
mode), ``render_until`` (a noise target).

Around the renderer, as in tpurt: ray queries (``query``: ``trace_rays``,
``occlusion``, ``light_probe``), the AOV pass and the à-trous denoiser
(``denoise``), temporal reprojection (``temporal``), JSON scenes
(``utils.scene_io``), PNG/PFM/PPM (``utils.image``), the blit's routes
from a state or from planes (``kernels.tonemap``), and the twins of
tpurt's tools (``python -m tpurt_torch.tools.animate``, ``python -m
tpurt_torch.tools.bake_ao``). tpurt computes the query, denoise and
temporal functions in jnp outside any Pallas kernel, so the port's are
plain PyTorch on the scene's or image's device.
"""

from tpurt_torch.adaptive import render_adaptive, wavefront_render_budget
from tpurt_torch.camera import (Camera, CameraController, MotionCamera,
                                base_camera, make_camera, set_vfov)
from tpurt_torch.config import RenderConfig
from tpurt_torch.denoise import atrous_denoise, denoise_image, render_aovs
from tpurt_torch.query import RayHits, light_probe, occlusion, trace_rays
from tpurt_torch.render import (RenderState, init_state, load_checkpoint,
                                render, render_step, render_until,
                                resolve_image, resolve_radiance,
                                save_checkpoint)
from tpurt_torch.scene import (Light, Material, MeshData, Scene, Sphere,
                               build_scene, cornell_spheres_scene,
                               default_scene, dispersive_scene,
                               instanced_scene, many_light_scene,
                               torus_field_scene, torus_mesh_scene,
                               tri_test_scene)
from tpurt_torch.wavefront import WavefrontPool, wavefront_render

__all__ = [
    "Camera", "CameraController", "Light", "Material", "MeshData", "MotionCamera", "RenderConfig",
    "RayHits", "RenderState", "Scene", "Sphere", "WavefrontPool",
    "atrous_denoise", "base_camera", "build_scene",
    "cornell_spheres_scene", "default_scene", "denoise_image",
    "dispersive_scene", "init_state", "instanced_scene", "light_probe",
    "load_checkpoint", "make_camera", "many_light_scene", "occlusion",
    "render", "render_adaptive", "render_aovs", "render_step",
    "render_until", "resolve_image", "resolve_radiance", "save_checkpoint",
    "trace_rays",
    "set_vfov", "torus_field_scene", "torus_mesh_scene", "tri_test_scene",
    "wavefront_render", "wavefront_render_budget",
]
