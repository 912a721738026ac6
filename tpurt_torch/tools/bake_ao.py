"""Ambient-occlusion baking through the ray-query API (the twin of tpurt's
``examples/bake_ao.py``): no camera, no film.

For every point of a grid over the Cornell floor: one closest-hit query
down to find the receiver, then a cosine-hemisphere batch of occlusion
probes about its normal (from ``np.random.default_rng(7)``, the same draws
as tpurt's); the AO of a texel is the mean transmittance of its probes, 1
where the finder missed. The queries run as two flat batches on the CUDA
card (--cpu: on the CPU).

    python -m tpurt_torch.tools.bake_ao [--res 128] [--rays 64] [--out ao.png]
"""

from __future__ import annotations

import argparse

import numpy as np


def finders(res: int = 128, span: float = 9.0):
    """The finder rays, straight down from y = 9.5 over a ``span``-wide
    res x res grid: origins and directions, (res*res, 3) float32 NumPy."""
    R = int(res)
    # the Cornell box interior is x, z in (-5, 5): keep the grid inside it
    xs = np.linspace(-span / 2, span / 2, R, dtype=np.float32)
    zs = np.linspace(-span / 2, span / 2, R, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs)
    o = np.stack([gx.ravel(), np.full(R * R, 9.5, np.float32), gz.ravel()],
                 -1)
    return o, np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (R * R, 1))


def probes(scene, res: int = 128, rays: int = 64, span: float = 9.0):
    """The bake's rays on ``scene``: (found (R*R,) bool, origins and
    directions (R*R*rays, 3) float32 NumPy) of the occlusion probes about
    the finder rays' hits."""
    from tpurt_torch.query import trace_rays
    R, S = int(res), int(rays)
    hits = trace_rays(scene, *finders(res, span))
    pos = hits.position.cpu().numpy()
    nrm = hits.normal.cpu().numpy()

    # cosine-weighted hemisphere probes about each receiver normal
    rng = np.random.default_rng(7)
    u1 = rng.random((R * R, S), np.float32)
    u2 = rng.random((R * R, S), np.float32)
    r = np.sqrt(u1)
    phi = 2.0 * np.pi * u2
    up = np.where(np.abs(nrm[:, 1:2]) < 0.9,
                  np.array([[0.0, 1.0, 0.0]], np.float32),
                  np.array([[1.0, 0.0, 0.0]], np.float32))
    t1 = np.cross(up, nrm)
    t1 /= np.maximum(np.linalg.norm(t1, axis=-1, keepdims=True), 1e-8)
    t2 = np.cross(nrm, t1)
    dirs = (t1[:, None] * (r * np.cos(phi))[..., None]
            + t2[:, None] * (r * np.sin(phi))[..., None]
            + nrm[:, None] * np.sqrt(np.maximum(1.0 - u1, 0.0))[..., None])
    org = np.repeat(pos + 1e-3 * nrm, S, axis=0)
    return hits.hit.cpu().numpy(), org, dirs.reshape(-1, 3)


def bake(scene=None, res: int = 128, rays: int = 64, span: float = 9.0,
         max_dist: float = 4.0, device=None) -> np.ndarray:
    """The (res, res) AO map of ``scene`` (on its device; None: the
    Cornell scene built on ``device``, the CUDA card unless the caller
    asks for another): ``rays`` probes a texel (``probes``) out to
    ``max_dist``; 1 where the finder missed."""
    from tpurt_torch.query import occlusion
    from tpurt_torch.scene import cornell_spheres_scene
    if scene is None:
        scene = cornell_spheres_scene(device=device)
    ok, org, dirs = probes(scene, res, rays, span)
    vis = occlusion(scene, org, dirs, t_max=max_dist)
    ao = vis.cpu().numpy().reshape(res * res, rays).mean(-1)
    return np.where(ok, ao, 1.0).reshape(res, res)


def main(argv=None) -> np.ndarray:
    from tpurt_torch.utils.image import write_png

    ap = argparse.ArgumentParser(prog="python -m tpurt_torch.tools.bake_ao",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--res", type=int, default=128, help="AO map resolution")
    ap.add_argument("--rays", type=int, default=64, help="probes per texel")
    ap.add_argument("--span", type=float, default=9.0, help="world extent")
    ap.add_argument("--max-dist", type=float, default=4.0,
                    help="occlusion radius (world units)")
    ap.add_argument("--out", default="ao.png")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    ao = bake(None, args.res, args.rays, args.span, args.max_dist,
              device="cpu" if args.cpu else None)
    img = np.repeat(ao[:, :, None], 3, axis=-1).astype(np.float32)
    write_png(args.out, img)
    R = args.res
    print(f"wrote {args.out}  (mean AO {ao.mean():.3f}, "
          f"{R * R * (args.rays + 1)} rays)")
    return ao


if __name__ == "__main__":
    main()
