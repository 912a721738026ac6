"""The tile-synchronized kernel (``backend="pallas", pallas_regen=False``):
the port's renders against tpurt's tile-sync kernel in Pallas interpret
mode at tests/test_photon_strata.py:43-56's shape (64x32, depth 4, K=2,
strata 8, seed 1234, 2 spp); ``pallas_regen=False`` against
``pallas_regen=True`` inside the port; and, on a CUDA device,
``step_call`` against ``render_plain`` with one sample and the two kernels
against each other.

Tolerances: ray counts exact; rgb_sum against tpurt by the image rule of
tests/test_golden.py (median |diff| < 1e-4, fewer than 1% of pixels off by
more than 1e-2: tpurt's kernel and the port round in other orders); inside
the port, bit for bit.

``python -m pytest tests/test_torch_tile_sync.py -m gpu --noconftest``
runs the GPU cases where JAX is not installed.
"""

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate
from tpurt_torch.kernels import mega_regen, mega_step
from tpurt_torch.render import state_to_planes
from tpurt_torch.scene import freeze_scene

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"

torch.set_num_threads(1)

CAM = ((0.0, 5.0, -12.0), (0.0, 5.0, 0.0))
KW = dict(width=64, height=32, depth=4, tile_size=2048, pallas_lanes=512,
          k_photons=2, max_photon_bounces=3, backend="pallas",
          pallas_regen=False, photon_strata=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_tile_sync.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _cam(w=64, h=32):
    return tt.make_camera(*CAM, vfov=60.0, aspect_ratio=w / h)


def test_matches_tpurt_tile_sync_interpret():
    import tpurt
    cfg_j = tpurt.RenderConfig(**KW)
    st_j = tpurt.render(tpurt.cornell_spheres_scene(), cfg_j,
                        tpurt.make_camera(*CAM, vfov=60.0, aspect_ratio=2.0),
                        tpurt.init_state(cfg_j), 1234, 2)
    cfg = tt.RenderConfig(**KW)
    before = mega_step.LAUNCHES
    st = tt.render(tt.cornell_spheres_scene(device=CPU), cfg, _cam(),
                   tt.init_state(cfg, device=CPU), 1234, 2)
    assert mega_step.LAUNCHES == before     # the CPU runs the plain version
    assert int(st.rays) == float(st_j.rays) > 0
    assert st.photon_radius == float(st_j.photon_radius)
    assert st.iteration == int(st_j.iteration) == 2
    n = cfg.n_pixels
    diff = np.abs(st.rgb_sum.numpy()[:n] - np.asarray(st_j.rgb_sum)[:n])
    frac = (diff.max(-1) > 1e-2).mean()
    print(f"median |diff| {np.median(diff):.3g}, {frac:.2%} pixels > 1e-2")
    assert np.median(diff) < 1e-4
    assert frac < 0.01


@pytest.mark.parametrize("flags", [
    dict(photon_strata=0),
    dict(photon_strata=8),
    dict(photon_strata=16, photon_strata_dir=4096,
         photon_strata_shared_k=True, photon_strata_bounce=True,
         camera_strata_bounce=True, photon_strata_window=4,
         hero_wavelengths=4, dispersion_in_camera_path=True),
], ids=["reference", "strata8", "every_flag"])
def test_tile_sync_equals_regen(flags):
    """pallas_regen=False against True: the same state bit for bit."""
    cfg = tt.RenderConfig(**{**KW, **flags})
    scene = tt.cornell_spheres_scene(device=CPU)
    st_t = tt.render(scene, cfg, _cam(), tt.init_state(cfg, device=CPU), 9,
                     3)
    c_r = cfg.with_(pallas_regen=True)
    st_r = tt.render(scene, c_r, _cam(), tt.init_state(c_r, device=CPU), 9,
                     3)
    assert torch.equal(state_to_planes(st_t), state_to_planes(st_r))
    assert int(st_t.rays) == int(st_r.rays) > 0
    assert st_t.photon_radius == st_r.photon_radius
    assert st_t.iteration == st_r.iteration == 3


def test_render_step_depth_reaches_the_kernel():
    """render_step's depth override reaches step_call: a depth-1 preview
    traces one camera segment per pixel plus the photon pass, as
    render_plain with depth 1 does."""
    cfg = tt.RenderConfig(**KW)
    scene = tt.cornell_spheres_scene(device=CPU)
    st0 = tt.init_state(cfg, device=CPU)
    prev = tt.render_step(scene, cfg, _cam(), st0, 3, depth=1)
    planes = state_to_planes(st0)
    rays = integrate.render_plain(freeze_scene(scene), cfg, _cam(), planes,
                                  3, 1, 0, cfg.photon_radius_init, 1)
    assert int(prev.rays) == int(rays) > 0
    assert torch.equal(state_to_planes(prev), planes)
    full = tt.render_step(scene, cfg, _cam(), st0, 3)
    assert int(full.rays) > int(prev.rays)


# ----- the kernel against its plain version (GPU only) -----

@pytest.mark.gpu
@pytest.mark.parametrize("flags", [dict(photon_strata=0), dict(
    photon_strata=16, photon_strata_dir=4096, photon_strata_shared_k=True,
    photon_strata_bounce=True, camera_strata_bounce=True,
    photon_strata_window=4, hero_wavelengths=4)],
    ids=["reference", "sampler"])
def test_step_call_matches_plain(cuda, flags):
    """One sample at iteration 5, radius 1.5: rays and every plane bit for
    bit."""
    cfg = tt.RenderConfig(**{**KW, **flags})
    scene = tt.cornell_spheres_scene(device=cuda)
    planes = state_to_planes(tt.init_state(cfg, device=cuda))
    pk, pp = planes.clone(), planes.clone()
    before = mega_step.LAUNCHES
    rk = int(mega_step.step_call(scene, cfg, _cam(), pk, 1234, 5, 1.5, 4))
    assert mega_step.LAUNCHES == before + 1
    rp = int(integrate.render_plain(freeze_scene(scene), cfg, _cam(), pp,
                                    1234, 1, 5, 1.5, 4))
    assert rk == rp > 0
    assert torch.equal(pk, pp)


@pytest.mark.gpu
def test_tile_sync_kernel_equals_regen_kernel(cuda):
    cfg = tt.RenderConfig(**KW)
    scene = tt.cornell_spheres_scene(device=cuda)
    before = (mega_step.LAUNCHES, mega_regen.LAUNCHES)
    st_t = tt.render(scene, cfg, _cam(), tt.init_state(cfg, device=cuda),
                     1234, 4)
    c_r = cfg.with_(pallas_regen=True)
    st_r = tt.render(scene, c_r, _cam(), tt.init_state(c_r, device=cuda),
                     1234, 4)
    assert (mega_step.LAUNCHES, mega_regen.LAUNCHES) == (before[0] + 4,
                                                         before[1] + 1)
    assert torch.equal(state_to_planes(st_t), state_to_planes(st_r))
    assert int(st_t.rays) == int(st_r.rays) > 0
