"""Scene and camera setup shared by the port's tools (``viewer.py
_build``): the named scenes with their default cameras, or a JSON scene
file, the mesh scene's sampler stack, ``--set KEY=VAL`` overrides applied
last, and the aperture and focus distance."""

from __future__ import annotations

import numpy as np

from tpurt_torch import scene as sc
from tpurt_torch.camera import make_camera
from tpurt_torch.config import RenderConfig

# name -> (builder taking device=, (eye, look_at, vfov))
SCENES = {
    "cornell": (sc.cornell_spheres_scene, ((0, 5, -12), (0, 5, 0), 60.0)),
    "default": (sc.default_scene, ((0, 0, -0.01), (0, 0, 1), 75.0)),
    "dispersive": (sc.dispersive_scene, ((0, 3, -4), (0, 1, 5), 55.0)),
    "instanced": (lambda device: sc.instanced_scene(256, device=device),
                  ((0, 10, -14), (0, 1, 8), 55.0)),
    "mesh": (lambda device: sc.torus_mesh_scene(45, 45, device=device),
             ((0, 3, -6), (0, 1.5, 0), 55.0)),
}

# the mesh scene's sampler stack (the dynamic BVH walk at leaf 64 with
# photon and camera strata)
MESH_FLAGS = dict(pallas_bvh=True, pallas_bvh_leaf=64, photon_strata=16,
                  photon_strata_dir=4096, photon_strata_shared_k=True,
                  photon_strata_bounce=True, camera_strata_bounce=True,
                  photon_strata_window=8)


def build(args, device=None):
    """(cfg, scene, camera, vfov, eye, look_at) from the tools' arguments
    (scene, scene_file, width, height, depth, backend, hero, dispersion,
    and where present aperture, focus, clamp, shutter, set). The scene is
    built on ``device``, the CUDA card unless the caller asks for
    another."""
    from tpurt_torch.utils.scene_io import load_scene_json
    if args.scene_file:
        scene, cam_meta = load_scene_json(args.scene_file, device=device)
        cam_meta = cam_meta or {}
        eye = tuple(cam_meta.get("eye", (0, 3, -8)))
        at = tuple(cam_meta.get("look_at", (0, 1, 0)))
        vfov = float(cam_meta.get("vfov", 60.0))
    else:
        builder, (eye, at, vfov) = SCENES[args.scene]
        scene = builder(device=device)
    # parsed first so that the backend-dependent flags below see the
    # effective backend (--set backend=... acts as --backend)
    overrides = RenderConfig.parse_overrides(getattr(args, "set", None))
    eff_backend = overrides.get("backend", args.backend)
    extra = {}
    if args.scene == "mesh" and not args.scene_file:
        extra = dict(MESH_FLAGS)
        if eff_backend.startswith("wavefront"):
            # the wavefront tracers reject camera bounce strata
            extra.pop("camera_strata_bounce")
    # None means "not given": an explicit --aperture 0 overrides a scene
    # file's camera; a focus of 0 or None is the look-at distance
    aperture = getattr(args, "aperture", None)
    focus = getattr(args, "focus", None)
    if args.scene_file:
        if aperture is None:
            aperture = float(cam_meta.get("aperture", 0.0))
        if not focus:
            focus = float(cam_meta.get("focus_dist", 0.0))
    if aperture is None:
        aperture = 0.0
    if not focus:
        focus = float(np.linalg.norm(np.asarray(at, np.float64)
                                     - np.asarray(eye, np.float64)))
    extra.update(overrides)
    cfg = RenderConfig(**{**dict(
        width=args.width, height=args.height, depth=args.depth,
        backend=args.backend, hero_wavelengths=args.hero,
        aperture=aperture, focus_dist=focus,
        radiance_clamp=getattr(args, "clamp", 0.0),
        motion_blur=getattr(args, "shutter", 0.0) > 0.0,
        dispersion_in_camera_path=args.dispersion), **extra})
    cam = make_camera(eye, at, vfov=vfov,
                      aspect_ratio=args.width / args.height)
    return cfg, scene, cam, vfov, eye, at
