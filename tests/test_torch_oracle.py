"""tpurt_torch against the reference-faithful scalar oracle
(tests/wgsl_oracle.py), as tests/test_reference_oracle.py holds tpurt.

The oracle transcribes the reference's estimator per pixel with its single
RNG stream; the port draws tpurt's per-phase streams. Both render the same
scene with the same per-frame seeds (frame_seed), so the comparison is
statistical: per-pixel z-scores against the oracle's variance of the mean
(both estimators carry noise, hence the 2x SE normalisation) and a bound
on the mean image. Marked slow, as tests/test_reference_oracle.py is.
"""

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch.ops.rng import frame_seed
from wgsl_oracle import render_oracle, scene_from_tpurt

pytestmark = pytest.mark.slow


def _compare(scene, cam, W, H, D, N, base_seed, mean_tol=0.02):
    """tests/test_reference_oracle.py:_compare with the port's renderer:
    no pixel beyond 5 sigma, the mean image within ``mean_tol``."""
    seeds = [frame_seed(base_seed, k) for k in range(N)]
    omean, ovar = render_oracle(scene_from_tpurt(scene), cam, W, H, D, seeds,
                                track_var=True)
    cfg = tt.RenderConfig(width=W, height=H, depth=D, tile_size=W * H)
    st = tt.render(scene, cfg, cam, tt.init_state(cfg), base_seed, N)
    timg = st.rgb_sum[:W * H].numpy().reshape(H, W, 3) / N
    z = np.abs(timg - omean) / np.maximum(2.0 * np.sqrt(ovar), 1e-3)
    assert (z > 5.0).mean() == 0.0, (
        f"{(z > 5.0).sum()} pixels beyond 5 sigma (max z {z.max():.1f}): "
        f"estimator drift from the reference")
    rel = abs(timg.mean() - omean.mean()) / max(abs(omean.mean()), 1e-9)
    assert rel < mean_tol, f"mean image off by {rel:.2%} vs the oracle"
    return omean, timg


def test_mesh_scene_matches_reference():
    """The mesh scene of tpurt's test_mesh_scene_matches_reference: a lit
    quad over the ground sphere, which receives NEE and shadows the ground
    behind it (Moller-Trumbore closest hit, the sphere/mesh merge, full
    triangle occlusion), 16x9, depth 6, 250 frames, seed 555."""
    torch.set_num_threads(1)
    materials = [tt.Material.diffuse((0.8, 0.8, 0.8)),
                 tt.Material.diffuse((0.85, 0.2, 0.2))]
    mesh = tt.MeshData(material_id=1)
    quad = np.array([[-1.5, 0.0, 2.0], [1.5, 0.0, 2.0], [1.5, 2.5, 2.0],
                     [-1.5, 2.5, 2.0]], np.float32)
    mesh.add_triangles(quad, np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    spheres = [tt.Sphere(0, 1000.0, (0.0, -1000.0, 0.0))]
    lights = [tt.Light.point((0.0, 4.0, -3.0), (1.0, 1.0, 0.9), 30.0,
                             5500.0)]
    scene = tt.build_scene(materials, spheres, [mesh], lights)
    cam = tt.make_camera((0.0, 1.5, -5.0), (0.0, 1.0, 0.0), vfov=70.0,
                         aspect_ratio=16 / 9)
    omean, _ = _compare(scene, cam, 16, 9, 6, 250, base_seed=555)
    assert omean.mean() > 0.03
