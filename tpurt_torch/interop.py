"""NumPy interchange between tpurt and the port.

tpurt's arrays, converted with ``np.asarray``, become the port's objects
and back, so both packages can render the same scene from the same state.
tpurt_torch never imports tpurt (which imports JAX); the caller converts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpurt_torch.camera import Camera, MotionCamera
from tpurt_torch.denoise import AOVs
from tpurt_torch.device import resolve_device
from tpurt_torch.query import RayHits
from tpurt_torch.render import RenderState
from tpurt_torch.scene import Scene, scene_from_arrays
from tpurt_torch.temporal import TemporalState

_STATE_DTYPES = {
    "rgb_sum": np.float32, "n_samples": np.float32, "vis_pos": np.float32,
    "vis_norm": np.float32, "vis_wo": np.float32, "vis_tp": np.float32,
    "vis_mat": np.int32,
}


def scene_from_numpy(fields: dict, device=None) -> Scene:
    """Scene on ``device`` (the CUDA card by default) from the fields of a
    tpurt.Scene (as NumPy arrays or anything np.asarray takes), triangles
    and BVH included."""
    arrays = {}
    for f in dataclasses.fields(Scene):
        a = np.asarray(fields[f.name])
        arrays[f.name] = a.astype(np.int64 if a.ndim == 0 else np.int32
                                  if a.dtype.kind in "iu" else np.float32)
    return scene_from_arrays(arrays, device)


def camera_from_numpy(origin, horizontal, vertical, lower_left) -> Camera:
    """Camera from the four (3,) vectors of a tpurt Camera."""
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a, dtype=np.float32).reshape(3))
    return Camera(origin=t(origin), horizontal=t(horizontal),
                  vertical=t(vertical), lower_left=t(lower_left))


def motion_camera_from_numpy(cam0, cam1) -> MotionCamera:
    """MotionCamera from the two poses of a tpurt MotionCamera, each the
    four (3,) vectors (origin, horizontal, vertical, lower_left) of its
    Camera."""
    return MotionCamera(cam0=camera_from_numpy(*cam0),
                        cam1=camera_from_numpy(*cam1))


def state_from_numpy(fields: dict, device=None) -> RenderState:
    """RenderState on ``device`` (the CUDA card by default) from the 10
    fields of a tpurt RenderState."""
    device = resolve_device(device)
    kw = {name: torch.from_numpy(np.array(fields[name], dtype=dt)).to(device)
          for name, dt in _STATE_DTYPES.items()}
    return RenderState(
        **kw, iteration=int(np.asarray(fields["iteration"])),
        photon_radius=float(np.float32(np.asarray(fields["photon_radius"]))),
        rays=torch.tensor(int(round(float(np.asarray(fields["rays"])))),
                          dtype=torch.int64, device=device))


def state_to_numpy(state: RenderState) -> dict:
    """The 10 RenderState fields as NumPy, in tpurt's dtypes, except
    ``rays``: float64, exact to 2**53 where tpurt's float32 is not."""
    out = {name: getattr(state, name).detach().cpu().numpy().astype(
        dt, order="C") for name, dt in _STATE_DTYPES.items()}
    out["iteration"] = np.asarray(state.iteration, np.int32)
    out["photon_radius"] = np.asarray(state.photon_radius, np.float32)
    out["rays"] = np.asarray(float(state.rays), np.float64)
    return out


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def aovs_from_numpy(albedo, normal, depth, device=None) -> AOVs:
    """AOVs on ``device`` (the CUDA card by default) from the three planes
    of a tpurt AOVs."""
    device = resolve_device(device)
    return AOVs(albedo=_tensor(albedo, np.float32, device),
                normal=_tensor(normal, np.float32, device),
                depth=_tensor(depth, np.float32, device))


def temporal_state_from_numpy(img, depth, camera: Camera,
                              device=None) -> TemporalState:
    """TemporalState on ``device`` (the CUDA card by default) from a tpurt
    TemporalState's image and depth and the port's Camera of its camera
    (``camera_from_numpy``)."""
    device = resolve_device(device)
    return TemporalState(img=_tensor(img, np.float32, device),
                         depth=_tensor(depth, np.float32, device),
                         camera=camera)


_HIT_DTYPES = {"hit": np.bool_, "t": np.float32, "position": np.float32,
               "normal": np.float32, "mat_id": np.int32,
               "albedo": np.float32, "mtype": np.int32}


def ray_hits_from_numpy(fields: dict, device=None) -> RayHits:
    """RayHits on ``device`` (the CUDA card by default) from the fields of
    a tpurt RayHits."""
    device = resolve_device(device)
    return RayHits(**{name: _tensor(fields[name], dt, device)
                      for name, dt in _HIT_DTYPES.items()})
