"""Camera of the port (``tpurt.camera``): the pinhole basis, the thin lens
(``aperture``/``focus_dist``), the shutter (``MotionCamera`` under
``motion_blur``), the camera spawn and the fly-camera controller.

The basis is host math in NumPy, like tpurt's; the four vectors are
float32 CPU tensors, read as constants by the integrator and packed into
the kernels' parameter table (a ``MotionCamera``'s shutter-close deltas
travel in the launch's spawn switches, ``kernels/mega_regen.spawn_args``).

The spawn draws, in this order in every backend: 2 jitter draws (the
caller's), the shutter time under ``motion_blur``, the 2 lens draws when
``aperture > 0``, then the wavelength (the caller's). Under ``qmc`` they
come from the Sobol stream (``ops.qmc``), else from the PCG stream. The
lens math is tpurt's ``lens_perturb_c`` with ``1/sqrt`` for its ``rsqrt``,
which the kernels compute the same way (``csrc/path.cuh
spawn_camera_ext``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpurt_torch.ops import fdiv, fsqrt
from tpurt_torch.ops import rng as rngmod

MOUSE_SCALING = 0.0000017  # ref: camera.rs:9
FRAC_2_PI = 2.0 / math.pi
_TWO_PI_F32 = float(np.float32(2.0 * math.pi))


@dataclasses.dataclass(frozen=True)
class Camera:
    """ray(u, v) = lower_left + u*horizontal + v*vertical - origin, with
    directions left unnormalized as in the reference."""
    origin: torch.Tensor       # (3,) f32
    horizontal: torch.Tensor   # (3,) f32
    vertical: torch.Tensor     # (3,) f32
    lower_left: torch.Tensor   # (3,) f32

    def rows(self) -> np.ndarray:
        """(4, 3) float32: origin, horizontal, vertical, lower_left."""
        return np.stack([v.detach().cpu().numpy().astype(np.float32)
                         for v in (self.origin, self.horizontal,
                                   self.vertical, self.lower_left)])


def _camera(origin, horizontal, vertical, lower_left) -> Camera:
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return Camera(origin=t(origin), horizontal=t(horizontal),
                  vertical=t(vertical), lower_left=t(lower_left))


def make_camera(look_from, look_at, v_up=(0.0, 1.0, 0.0), vfov=75.0,
                aspect_ratio=16.0 / 9.0) -> Camera:
    """The RTiOW camera basis (``tpurt.camera.make_camera``)."""
    look_from = np.asarray(look_from, np.float32)
    look_at = np.asarray(look_at, np.float32)
    v_up = np.asarray(v_up, np.float32)

    theta = vfov * math.pi / 180.0
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(w, v_up)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    origin = look_from
    horizontal = viewport_width * u
    vertical = viewport_height * v
    lower_left = origin - 0.5 * horizontal - 0.5 * vertical - w
    return _camera(origin, horizontal, vertical, lower_left)


def set_vfov(cam: Camera, vfov: float, aspect_ratio: float) -> Camera:
    """The viewport rebuilt at a new vertical FOV around the camera's
    current axes (``tpurt.camera.set_vfov``)."""
    theta = vfov * math.pi / 180.0
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    origin, hz, vt, _ = cam.rows()
    u = hz / np.linalg.norm(hz)
    v = vt / np.linalg.norm(vt)
    w = np.cross(u, v)

    horizontal = viewport_width * u
    vertical = viewport_height * v
    lower_left = origin - 0.5 * horizontal - 0.5 * vertical - w
    return _camera(origin, horizontal, vertical, lower_left)


@dataclasses.dataclass(frozen=True)
class MotionCamera:
    """The shutter-open and shutter-close poses of a camera under
    ``motion_blur``: each camera ray draws a shutter time u_t and uses the
    basis lerp(cam0, cam1, u_t). Geometry is static."""
    cam0: Camera
    cam1: Camera

    def rows(self) -> np.ndarray:
        """The shutter-open basis rows (``Camera.rows``): what the
        kernels' parameter table holds."""
        return self.cam0.rows()


def motion_rows(camera: MotionCamera) -> np.ndarray:
    """(8, 3) float32: rows 0-3 the shutter-open basis (origin, horizontal,
    vertical, lower_left), rows 4-7 the deltas to shutter close; the basis
    at time t is row_i + t * row_{i+4}."""
    base = camera.cam0.rows()
    return np.concatenate([base, camera.cam1.rows() - base]).astype(
        np.float32)


def check_camera(cfg, camera) -> None:
    """The camera kind a render call needs (``tpurt.render.
    _check_camera_kind``): a MotionCamera exactly under motion_blur."""
    is_motion = isinstance(camera, MotionCamera)
    if cfg.motion_blur and not is_motion:
        raise TypeError("cfg.motion_blur=True needs a camera.MotionCamera "
                        "(shutter open/close pose pair), got a Camera")
    if is_motion and not cfg.motion_blur:
        raise TypeError("got a MotionCamera but cfg.motion_blur is False: "
                        "set RenderConfig(motion_blur=True) or pass "
                        "camera.cam0")


def base_camera(camera) -> Camera:
    """The shutter-open Camera of a Camera or a MotionCamera."""
    return camera.cam0 if isinstance(camera, MotionCamera) else camera


def generate_rays(cam: Camera, u, v):
    """Primary rays at fractional pixel coords (planes u, v): returns
    (origin, direction) as vec3s of planes, direction unnormalized."""
    o, h, vv, ll = (tuple(float(x) for x in row) for row in cam.rows())
    d = tuple(ll[c] + u * h[c] + v * vv[c] - o[c] for c in range(3))
    return tuple(torch.full_like(u, o[c]) for c in range(3)), d


def lerp_camera_vecs(camera: MotionCamera, u_t):
    """The basis at the per-lane shutter times ``u_t``: (origin,
    horizontal, vertical, lower_left), each a vec3 of planes."""
    rows = motion_rows(camera)
    return tuple(
        tuple(float(rows[i, c]) + u_t * float(rows[i + 4, c])
              for c in range(3)) for i in range(4))


def lerp_components_c(camera: MotionCamera, u_t):
    """``lerp_camera_vecs`` in tpurt's kernel order: (lower_left,
    horizontal, vertical, origin)."""
    o, h, v, ll = lerp_camera_vecs(camera, u_t)
    return ll, h, v, o


def _check_focus(focus_dist: float) -> None:
    if focus_dist <= 0.0:
        raise ValueError("aperture > 0 requires focus_dist > 0 "
                         "(the sharp-plane distance; see RenderConfig)")


def _inv_norm(h):
    """1 / |h| of a vec3 of Python floats (a float32 value) or of planes,
    summed in the kernels' order and rounded as they round it."""
    if isinstance(h[0], torch.Tensor):
        return fdiv(1.0, fsqrt(h[0] * h[0] + h[1] * h[1] + h[2] * h[2]))
    h32 = [np.float32(x) for x in h]
    n2 = h32[0] * h32[0] + h32[1] * h32[1] + h32[2] * h32[2]
    return float(np.float32(1.0) / np.sqrt(n2))


def lens_perturb_c(aperture: float, focus_dist: float, rng, o0, d0, cam_h,
                   cam_v, rand_1f=rngmod.rand_1f):
    """Thin-lens defocus in component form (``tpurt.camera.
    lens_perturb_c``): two draws, then the ray's origin moves by ``off``,
    a point of the disc of diameter ``aperture`` in the basis (cam_h,
    cam_v), and its direction by -off / focus_dist, so the plane at
    focus_dist stays sharp. cam_h, cam_v: vec3s of Python floats or of
    planes; o0, d0: vec3s of planes. Returns (o, d, rng)."""
    _check_focus(focus_dist)
    u1, rng = rand_1f(rng)
    u2, rng = rand_1f(rng)
    hinv = _inv_norm(cam_h)
    vinv = _inv_norm(cam_v)
    r = fsqrt(u1) * float(np.float32(0.5 * aperture))
    phi = u2 * _TWO_PI_F32
    a = r * torch.cos(phi) * hinv
    b = r * torch.sin(phi) * vinv
    off = tuple(a * cam_h[c] + b * cam_v[c] for c in range(3))
    finv = float(np.float32(1.0 / focus_dist))
    return (tuple(o0[c] + off[c] for c in range(3)),
            tuple(d0[c] - off[c] * finv for c in range(3)), rng)


def lens_perturb(cam: Camera, aperture: float, focus_dist: float, o, d, rng):
    """``lens_perturb_c`` in the basis of one Camera."""
    _, h, v, _ = (tuple(float(x) for x in row) for row in cam.rows())
    return lens_perturb_c(aperture, focus_dist, rng, o, d, h, v)


def lens_perturb_hv(aperture: float, focus_dist: float, h, v, o, d, rng):
    """``lens_perturb_c`` in an explicit (per-lane) basis h, v."""
    return lens_perturb_c(aperture, focus_dist, rng, o, d, h, v)


def spawn_camera_rays(cfg, camera, u, v, rng):
    """The camera rays at fractional pixel coords (planes u, v) after the
    jitter draws: the shutter-time draw under motion_blur (``camera`` is
    then a MotionCamera), the ray through the lerped or fixed basis, the
    two lens draws when aperture > 0. The caller draws the wavelength
    next. Returns (o, d, rng)."""
    if cfg.motion_blur:
        u_t, rng = rngmod.rand_1f(rng)
        o, h, vv, ll = lerp_camera_vecs(camera, u_t)
        d = tuple(ll[c] + u * h[c] + v * vv[c] - o[c] for c in range(3))
    else:
        o, d = generate_rays(camera, u, v)
        _, h, vv, _ = (tuple(float(x) for x in row) for row in camera.rows())
    if cfg.aperture > 0.0:
        o, d, rng = lens_perturb_c(cfg.aperture, cfg.focus_dist, rng, o, d,
                                   h, vv)
    return o, d, rng


def _rot_axis_angle(axis, angle):
    """3x3 rotation about a unit axis (Rodrigues), host NumPy."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    C = 1.0 - c
    return np.array([
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ])


class CameraController:
    """Fly-camera controller (``tpurt.camera.CameraController``, after the
    reference's camera.rs): WASD/arrows strafe and dolly, Space/Ctrl move
    vertically, Shift doubles speed, mouse-look yaws about +Y then pitches
    about the horizontal axis, clamped short of vertical. Drive it with
    ``set_key(name, pressed)`` / ``mouse_move(dx, dy)`` and call
    ``update(camera, dt_micros)``; returns (new_camera, changed)."""

    KEYS = ("forward", "backward", "left", "right", "up", "down", "boost")

    def __init__(self, default_speed: float = 5e-6):
        self.default_speed = default_speed
        self.pressed = {k: False for k in self.KEYS}
        self.mouse_delta = np.zeros(2, np.float32)
        self.mouse_dragged = False

    def set_key(self, name: str, pressed: bool):
        if name not in self.pressed:
            raise KeyError(f"unknown control {name!r}; one of {self.KEYS}")
        self.pressed[name] = pressed

    def mouse_move(self, dx: float, dy: float):
        # overwrites, as the reference does: events between updates keep
        # only the last delta
        self.mouse_delta = np.array([dx, dy], np.float32)
        self.mouse_dragged = True

    def update(self, cam: Camera, duration_micros: float):
        p = self.pressed
        changed = any(p[k] for k in ("forward", "backward", "left", "right",
                                     "up", "down")) or self.mouse_dragged

        origin, horizontal, vertical, lower_left = (
            r.astype(np.float64) for r in cam.rows())

        forward = np.cross(vertical, horizontal)
        forward_mag = np.linalg.norm(forward)
        forward_n = forward / max(forward_mag, 1e-20)
        right_n = horizontal / max(np.linalg.norm(horizontal), 1e-20)
        up = np.array([0.0, 1.0, 0.0])

        speed = (self.default_speed * duration_micros
                 * (2.0 if p["boost"] else 1.0))

        def move(delta):
            nonlocal origin, lower_left
            origin = origin + delta
            lower_left = lower_left + delta

        # the forward_mag > speed gate is the reference's own (camera.rs:194)
        if p["forward"] and forward_mag > speed:
            move(forward_n * speed)
        if p["backward"]:
            move(-forward_n * speed)
        if p["right"]:
            move(right_n * speed)
        if p["left"]:
            move(-right_n * speed)
        if p["up"]:
            move(up * speed)
        if p["down"]:
            move(-up * speed)

        if self.mouse_dragged:
            ang_h = (MOUSE_SCALING * duration_micros * self.mouse_delta[0]
                     * FRAC_2_PI)
            Rh = _rot_axis_angle(up, ang_h)
            horizontal = Rh @ horizontal
            vertical = Rh @ vertical
            lower_left = Rh @ (lower_left - origin) + origin

            ang_v = (MOUSE_SCALING * duration_micros * self.mouse_delta[1]
                     * FRAC_2_PI)
            Rv = _rot_axis_angle(horizontal / np.linalg.norm(horizontal),
                                 ang_v)
            new_vertical = Rv @ vertical
            # the pitch is rejected once the new vertical would align with
            # +Y (camera.rs:248-255, its signed test kept)
            nv = new_vertical / max(np.linalg.norm(new_vertical), 1e-20)
            cosang = np.dot(nv, up)
            sinang = np.linalg.norm(np.cross(nv, up))
            tanang = sinang / cosang if cosang != 0.0 else math.inf
            if tanang < 1e-10:
                vertical = new_vertical
                lower_left = Rv @ (lower_left - origin) + origin
            self.mouse_delta = np.zeros(2, np.float32)
            self.mouse_dragged = False

        return (_camera(origin, horizontal, vertical, lower_left),
                bool(changed))
