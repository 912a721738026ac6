"""Offline animation renderer (the twin of tpurt's ``tools/animate.py``):
a camera path -> numbered PNG frames, each rendered to --spp samples,
written as frame_0000.png ... under --out-dir.

Camera paths:
  --orbit          turntable: the eye circles the look-at point at its
                   starting radius and height, one revolution over the
                   sequence
  --path FILE      keyframe JSON: [{"frame": 0, "eye": [x,y,z],
                   "look_at": [x,y,z], "vfov": 60.0}, ...], linear
                   interpolation between bracketing keyframes (vfov too)
  (neither)        a fixed camera: frames differ only by seed

Resume: existing frame files are skipped (not under --temporal, whose
history needs every frame). Without --denoise or --temporal a frame is
render then ``resolve_image`` (the blit kernel on the card); with them
render, the AOV pass, the à-trous filter (or the plain resolve), the
temporal blend, then the tonemap. Runs on the CUDA card; --cpu runs on the
CPU.

Usage:
  python -m tpurt_torch.tools.animate --scene cornell --orbit --frames 60 \\
      --spp 64 --out-dir anim
  python -m tpurt_torch.tools.animate --scene-file examples/torus_glass.json \\
      --path path.json --frames 48 --spp 128 --out-dir anim
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch


def orbit_camera(frame, n_frames, eye0, look_at, vfov, aspect):
    """Turntable: eye0 rotated about the vertical axis through look_at."""
    from tpurt_torch.camera import make_camera
    ang = 2.0 * math.pi * frame / max(n_frames, 1)
    rel = np.asarray(eye0, np.float64) - np.asarray(look_at, np.float64)
    c, s = math.cos(ang), math.sin(ang)
    rot = np.array([rel[0] * c + rel[2] * s, rel[1],
                    -rel[0] * s + rel[2] * c])
    eye = np.asarray(look_at, np.float64) + rot
    return make_camera(tuple(eye), tuple(look_at), vfov=vfov,
                       aspect_ratio=aspect)


def path_camera(frame, keys, aspect):
    """Linear interpolation between bracketing keyframes (eye, look_at,
    vfov), clamped before the first and after the last."""
    from tpurt_torch.camera import make_camera
    keys = sorted(keys, key=lambda k: k["frame"])
    lo = keys[0]
    hi = keys[-1]
    for a, b in zip(keys, keys[1:]):
        if a["frame"] <= frame <= b["frame"]:
            lo, hi = a, b
            break
    else:
        lo = hi = keys[0] if frame <= keys[0]["frame"] else keys[-1]
    span = max(hi["frame"] - lo["frame"], 1)
    t = min(max((frame - lo["frame"]) / span, 0.0), 1.0)

    def lerp3(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return tuple((1 - t) * a + t * b)

    vfov = ((1 - t) * float(lo.get("vfov", 60.0))
            + t * float(hi.get("vfov", 60.0)))
    return make_camera(lerp3(lo["eye"], hi["eye"]),
                       lerp3(lo["look_at"], hi["look_at"]),
                       vfov=vfov, aspect_ratio=aspect)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m tpurt_torch.tools.animate",
        description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="cornell",
                    choices=["cornell", "default", "dispersive", "instanced",
                             "mesh"])
    ap.add_argument("--scene-file", default=None, metavar="JSON")
    ap.add_argument("--path", default=None, metavar="JSON",
                    help="keyframe path file (overrides --orbit)")
    ap.add_argument("--orbit", action="store_true")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--depth", type=int, default=30)
    ap.add_argument("--backend", default="pallas",
                    choices=["pallas", "xla", "wavefront"])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--set", action="append", metavar="KEY=VAL",
                    help="override any RenderConfig field (repeatable), "
                         "e.g. --set qmc=True")
    ap.add_argument("--aperture", type=float, default=None,
                    help="thin-lens diameter for depth of field "
                         "(0 = pinhole)")
    ap.add_argument("--focus", type=float, default=None,
                    help="focus distance (default: the look-at point)")
    ap.add_argument("--clamp", type=float, default=0.0,
                    help="per-sample radiance clamp (0 = off)")
    ap.add_argument("--denoise", action="store_true",
                    help="à-trous denoise each frame (AOV-guided)")
    ap.add_argument("--shutter", type=float, default=0.0, metavar="FRAC",
                    help="motion blur: the shutter stays open for FRAC of "
                         "a frame interval (the camera at frame and "
                         "frame+FRAC)")
    ap.add_argument("--temporal", type=float, default=0.0, metavar="ALPHA",
                    help="blend each frame with the reprojected previous "
                         "frame (history weight ALPHA, e.g. 0.8; disables "
                         "resume)")
    return ap


def main(argv=None) -> dict:
    """Render the sequence; prints one line a frame on stderr and a JSON
    line (frames_rendered, out_dir, spp) on stdout. Returns that dict with
    ``frames``: per rendered frame its number, rays and the milliseconds
    of each stage (render, aov, denoise, temporal, png, total), the device
    synchronized at each stage's end."""
    from tpurt_torch import tonemap as tm
    from tpurt_torch.camera import MotionCamera, base_camera
    from tpurt_torch.denoise import denoise_image, render_aovs
    from tpurt_torch.render import (init_state, render, resolve_image,
                                    resolve_radiance)
    from tpurt_torch.temporal import temporal_blend
    from tpurt_torch.tools import scenes
    from tpurt_torch.utils.image import write_png

    ap = parser()
    args = ap.parse_args(argv)
    args.hero = 1
    args.dispersion = args.scene == "dispersive"
    cfg, scene, cam0, vfov, eye0, look_at = scenes.build(
        args, "cpu" if args.cpu else None)
    dev = scene.device

    keys = None
    if args.path:
        with open(args.path) as f:
            keys = json.load(f)
        if not keys:
            ap.error("--path file holds no keyframes")

    def cam_at(f):
        if keys is not None:
            return path_camera(f, keys, aspect)
        if args.orbit:
            return orbit_camera(f, args.frames, eye0, look_at, vfov, aspect)
        return cam0  # a fixed camera: frames differ only by seed

    clock = [time.perf_counter()]

    def lap() -> float:
        """Milliseconds since the last lap, the device synchronized."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        ms = (now - clock[0]) * 1e3
        clock[0] = now
        return ms

    os.makedirs(args.out_dir, exist_ok=True)
    aspect = args.width / args.height
    records = []
    tstate = None   # the temporal history
    for frame in range(args.frames):
        out = os.path.join(args.out_dir, f"frame_{frame:04d}.png")
        if os.path.exists(out) and not args.temporal:
            continue
        cam = cam_at(frame)
        if args.shutter > 0.0:
            cam = MotionCamera(cam0=cam, cam1=cam_at(frame + args.shutter))
        ms = dict(render=0.0, aov=0.0, denoise=0.0, temporal=0.0, png=0.0)
        lap()
        st = render(scene, cfg, cam, init_state(cfg, device=dev),
                    args.seed + frame, args.spp)
        ms["render"] = lap()
        if args.denoise or args.temporal:
            aovs = render_aovs(scene, cfg, cam)
            ms["aov"] = lap()
            if args.denoise:
                lin = denoise_image(scene, cfg, cam, st, aovs=aovs,
                                    tonemap=False)
            else:
                lin = resolve_radiance(cfg, st)
            ms["denoise"] = lap()
            if args.temporal:
                lin, tstate = temporal_blend(tstate, base_camera(cam), aovs,
                                             lin, alpha=args.temporal)
                ms["temporal"] = lap()
            img = tm.tonemap(lin, cfg.tonemap_key, cfg.tonemap_saturation)
        else:
            img = resolve_image(cfg, st)
        write_png(out, img)
        ms["png"] = lap()
        ms["total"] = sum(ms.values())
        rays = int(st.rays)
        records.append(dict(frame=frame, rays=rays, ms=ms))
        print(f"frame {frame:4d}  {args.spp} spp  {ms['total'] / 1e3:6.2f}s  "
              f"{rays / ms['total'] / 1e3:8.1f} Mrays/s  (render "
              f"{ms['render']:.1f} aov {ms['aov']:.1f} denoise "
              f"{ms['denoise']:.1f} temporal {ms['temporal']:.1f} png "
              f"{ms['png']:.1f} ms)  -> {out}", file=sys.stderr)
    stats = {"frames_rendered": len(records), "out_dir": args.out_dir,
             "spp": args.spp}
    print(json.dumps(stats))
    return dict(stats, frames=records)


if __name__ == "__main__":
    main()
