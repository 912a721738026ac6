"""tpurt's G-matrix leaf test (``cfg.pallas_mxu_leaf``) in tpurt_torch
against tpurt: where it engages (``kernels.bvh.mxu_leaf_engages`` against
``mega_pallas._use_mxu_leaf``), its table (``kernels.bvh.build_gmat``
against ``bvh_pallas.build_tri_gmat``), its leaf test (the plain G sweep
``ops.intersect.closest_triangle_g`` against ``closest_tri_bvh`` with a G
input in an interpret-mode ``pallas_call``), and whole renders through the
regen kernel's plain version, uniform and budget mode, against tpurt's
regen kernel in Pallas interpret mode; on a CUDA device (marker ``gpu``)
the probe's G leaf and the regen kernel's G instances against their plain
version. tpurt's own tests never turn the flag on: these pin it.

tpurt is imported inside the fixture ``tp`` so the GPU cases also run
where JAX is not installed:
``python -m pytest tests/test_torch_mxu_leaf.py -m gpu --noconftest``.

Tolerances: the predicate, the table and the ray counts exact; the leaf
test's t against tpurt bit for bit with its sums fused as XLA's CPU dot
fuses them, and rtol 1e-5 with the kernel's unfused sums; images by the
rule of tests/test_golden.py; on the card, bit for bit.
"""

import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate
from tpurt_torch.kernels import bvh, mega_regen
from tpurt_torch.ops import intersect
from tpurt_torch.render import state_to_planes
from tpurt_torch.scene import freeze_scene

from test_torch_mesh import _rays
from test_torch_mesh_render import TORUS_CAM, _image_rule

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"

torch.set_num_threads(1)

# 128x64, depth 5, seed 77, 2 spp on torus_mesh_scene(8, 4): tpurt's regen
# kernel counts 117899 segments with the flag, as without it
WALK = dict(backend="pallas", pallas_static_unroll=8, pallas_bvh=True,
            pallas_bvh_leaf=8, pallas_lanes=512)


@pytest.fixture(scope="module")
def tp():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    import tpurt
    from tpurt.kernels import bvh_pallas, mega_pallas, mega_regen as j_regen
    return types.SimpleNamespace(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu,
                                 tpurt=tpurt, bp=bvh_pallas, mp=mega_pallas,
                                 regen=j_regen)


def _fresh_gmat_cache(tp):
    """tpurt builds its G matrix inside the jit trace of its regen call and
    keeps it in an lru_cache (mega_pallas._gmat_build_cached), so a second
    traced call on the same triangles finds a leaked tracer. Its own tests
    never turn the flag on; these clear the cache before each call."""
    tp.mp._gmat_build_cached.cache_clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_mxu_leaf.py -m gpu --noconftest")
    return torch.device("cuda")


def _torus_cam(aspect):
    return tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=aspect)


# ----- (a) where the G leaf engages -----

# triangle counts below, inside (both ends) and above (static_unroll, 8192]
_SCENES = {32: (4, 4), 64: (8, 4), 8192: (64, 64), 8320: (64, 65)}
_BACKENDS = {"regen": dict(backend="pallas"),
             "tile-sync": dict(backend="pallas", pallas_regen=False),
             "xla": dict(backend="xla"),
             "wavefront_fused": dict(backend="wavefront_fused")}


@pytest.fixture(scope="module")
def frozen(tp):
    """(port frozen scene, tpurt frozen scene) per triangle count."""
    return {n: (freeze_scene(tt.torus_mesh_scene(*a, device=CPU)),
                tp.mp.freeze_scene(tp.tpurt.scene.torus_mesh_scene(*a)))
            for n, a in _SCENES.items()}


@pytest.mark.parametrize("backend", list(_BACKENDS))
@pytest.mark.parametrize("n_tris", list(_SCENES))
def test_engagement_equals_tpurt(tp, frozen, n_tris, backend):
    """mxu_leaf_engages against tpurt's _use_mxu_leaf on the regen path,
    over pallas_bvh, pallas_bvh_chunk and pallas_bvh_chunk_threshold."""
    fs, fs_j = frozen[n_tris]
    assert fs.triangles.count == len(fs_j.triangles) == n_tris
    kw = _BACKENDS[backend]
    regen_path = kw["backend"] == "pallas" and kw.get("pallas_regen", True)
    seen = set()
    for on in (True, False):
        for chunk in (0, 2048):
            for thresh in (0, 16):
                knobs = dict(pallas_mxu_leaf=True, pallas_bvh=on,
                             pallas_bvh_chunk=chunk,
                             pallas_bvh_chunk_threshold=thresh)
                want = regen_path and tp.mp._use_mxu_leaf(
                    fs_j, tp.tpurt.RenderConfig(**kw, **knobs))
                cfg = tt.RenderConfig(**kw, **knobs)
                tt.config.check_slice(cfg)
                assert bvh.mxu_leaf_engages(fs, cfg) == want, knobs
                assert not bvh.mxu_leaf_engages(
                    fs, cfg.with_(pallas_mxu_leaf=False))
                seen.add(want)
    assert seen == ({True, False} if regen_path and n_tris in (64, 8192)
                    else {False})


# ----- (b) the G table -----

@pytest.mark.parametrize("leaf,sah", [(8, False), (8, True), (64, False),
                                      (64, True)])
def test_gmat_equals_tpurt(tp, leaf, sah):
    """The port's G rows hold tpurt's non-zero blocks and payload bit for
    bit, row for row in the walk's leaf order; every other entry of
    tpurt's blocks and its guard rows is zero."""
    fs = freeze_scene(tt.torus_mesh_scene(8, 4, device=CPU))
    cfg = tt.RenderConfig(backend="pallas", pallas_static_unroll=8,
                          pallas_bvh_leaf=leaf, pallas_bvh_sah=sah,
                          pallas_mxu_leaf=True)
    got = bvh.gmat(fs, cfg).numpy()
    assert bvh.gmat(fs, cfg) is bvh.gmat(fs, cfg)        # cached
    rec = bvh.geometry(fs, cfg).tri.numpy()
    fs_j = tp.mp.freeze_scene(tp.tpurt.scene.torus_mesh_scene(8, 4))
    tab, _, _ = tp.bp.build_tri_bvh_tables(fs_j.triangles, leaf, sah)
    g = tp.bp.build_tri_gmat(tab, leaf)
    T = tab.shape[0]
    np.testing.assert_array_equal(rec[:, :13], tab[:, :13])
    cols = {0: (0, 3), 3: (16, 3), 6: (19, 3), 9: (32, 3), 12: (35, 3),
            15: (54, 3), 18: (57, 1), 20: (64, 3), 23: (67, 1)}
    used = np.zeros(72, bool)
    for mine, (theirs, k) in cols.items():
        np.testing.assert_array_equal(got[:, mine:mine + k],
                                      g[:T, theirs:theirs + k])
        used[theirs:theirs + k] = True
    assert not g[:T, ~used].any() and not g[T:].any()
    np.testing.assert_array_equal(got[:, intersect.G_INDEX], rec[:, 13])


# ----- (c) the leaf test -----

def _tpurt_g_walk(tp, fs_j, leaf, o, d):
    """tpurt's closest_tri_bvh with the G input (its MXU leaf) in an
    interpret-mode pallas_call, tests/test_bvh_pallas.py's pattern: t per
    ray for rays o, d (3, NR), NR a multiple of 256."""
    jnp, pl, pltpu = tp.jnp, tp.pl, tp.pltpu
    tab, node_f, node_i = tp.bp.build_tri_bvh_tables(fs_j.triangles, leaf)
    T = tab.shape[0]
    packed = jnp.asarray(tp.bp.pack_tables(tab, node_f, node_i, leaf))
    gm = jnp.asarray(tp.bp.build_tri_gmat(tab, leaf))
    R, NR = 2, o.shape[1]
    NT = NR // (R * 128)

    def kernel(rays_ref, tab_ref, g_ref, out_ref):
        ro = (rays_ref[0], rays_ref[1], rays_ref[2])
        rd = (rays_ref[3], rays_ref[4], rays_ref[5])
        nodes, tv = tp.bp.packed_views(tab_ref, T)
        t, _, mat = tp.bp.closest_tri_bvh(
            nodes, tv, ro, rd, jnp.ones_like(ro[0], bool), leaf_size=leaf,
            mxu_g_ref=g_ref)
        out_ref[0] = t
        out_ref[1] = mat.astype(jnp.float32)

    rays = jnp.asarray(np.concatenate([o, d]).reshape(6, NT, R, 128)
                       .swapaxes(0, 1).reshape(NT * 6, R, 128))
    out = pl.pallas_call(
        kernel, grid=(NT,),
        in_specs=[pl.BlockSpec((6, R, 128), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((2, R, 128), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=tp.jax.ShapeDtypeStruct((NT * 2, R, 128), jnp.float32),
        interpret=True)(rays, packed, gm)
    out = np.asarray(out).reshape(NT, 2, R * 128)
    return out[:, 0].reshape(-1)


def test_leaf_test_matches_tpurt_interpret(tp):
    """The plain G sweep against tpurt's G leaf inside its walk, on 2048
    seeded rays at torus_mesh_scene(8, 4), leaf 8. tpurt's interpret mode
    forms its four sums with fused multiply-adds in ascending feature
    order (XLA's CPU dot); the G sweep with ``fused=True`` gives its t bit
    for bit on every ray, so the port's rows, feature order, epilogue and
    winner are tpurt's, while the exact Moller-Trumbore sweep's t differs
    in the last bits on most hit rays. The sweep the kernel runs (no FMA):
    the same hit or miss on every ray, t within rtol 1e-5 (cancellation in
    the sums turns one rounding into up to tens of ulp of t). Its hit/miss
    agreement with the exact sweep (tpurt's leaf is not bit-identical to
    Moller-Trumbore at grazing rays): at least 0.997."""
    scene = tt.torus_mesh_scene(8, 4, device=CPU)
    fs = freeze_scene(scene)
    o, d, _, _ = _rays(scene, 2048, 21)
    want = _tpurt_g_walk(tp, tp.mp.freeze_scene(
        tp.tpurt.scene.torus_mesh_scene(8, 4)), 8, o, d)
    cfg = tt.RenderConfig(backend="pallas", pallas_static_unroll=8,
                          pallas_bvh_leaf=8, pallas_mxu_leaf=True)
    to = lambda x: tuple(torch.from_numpy(x))  # noqa: E731
    g = bvh.gmat(fs, cfg)
    got = intersect.closest_triangle_g(g, fs.triangles, to(o),
                                       to(d))[0].numpy()
    fused = intersect.closest_triangle_g(g, fs.triangles, to(o), to(d),
                                         fused=True)[0].numpy()
    exact = intersect.closest_triangle(fs.triangles, to(o), to(d))[0].numpy()
    hit = want < 1e29
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(fused, want)
    np.testing.assert_array_equal(got < 1e29, hit)
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-5)
    same_g = (got[hit] == want[hit]).mean()
    same_exact = (exact[hit] == want[hit]).mean()
    agree = ((got < 1e29) == (exact < 1e29)).mean()
    print(f"t equal to tpurt's on hit rays: G sweep {same_g:.3f}, exact "
          f"sweep {same_exact:.3f}; G against exact hit/miss agreement "
          f"{agree:.4f}")
    assert same_exact < 0.5
    assert agree >= 0.997


def test_g_sweep_ties_and_order():
    """The plain G sweep takes the least (t, scene index) whatever the row
    order of the table: reversed rows give the same winners."""
    scene = tt.torus_mesh_scene(8, 4, device=CPU)
    fs = freeze_scene(scene)
    cfg = tt.RenderConfig(backend="pallas", pallas_static_unroll=8,
                          pallas_bvh_leaf=8, pallas_mxu_leaf=True)
    g = bvh.gmat(fs, cfg)
    o, d = (tuple(torch.from_numpy(x)) for x in _rays(scene, 1024, 22)[:2])
    a = intersect.closest_triangle_g(g, fs.triangles, o, d)
    b = intersect.closest_triangle_g(g.flip(0), fs.triangles, o, d)
    assert torch.equal(a[0], b[0]) and torch.equal(a[4], b[4])
    hit = a[0] < 1e29
    assert hit.float().mean() > 0.2
    assert torch.equal(a[3][hit], fs.triangles.mat[a[4][hit]].long())


# ----- (d), (e) renders against tpurt's regen kernel in interpret mode -----

def test_render_matches_tpurt_regen_interpret(tp):
    """backend="pallas" with pallas_mxu_leaf (the regen kernel's plain
    version with the G sweep) against tpurt's interpret-mode regen kernel
    with the flag: 128x64, depth 5, seed 77, 2 spp, 117899 segments."""
    kw = dict(width=128, height=64, depth=5, pallas_mxu_leaf=True, **WALK)
    cfg_j = tp.tpurt.RenderConfig(**kw)
    _fresh_gmat_cache(tp)
    st_j = tp.regen.render_regen(
        tp.tpurt.scene.torus_mesh_scene(8, 4), cfg_j,
        tp.tpurt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=2.0),
        tp.tpurt.init_state(cfg_j), 77, 2)
    cfg = tt.RenderConfig(**kw)
    scene = tt.torus_mesh_scene(8, 4, device=CPU)
    assert mega_regen.regen_tri_mode(freeze_scene(scene), cfg).kind == \
        "gleaf"
    st = tt.render(scene, cfg, _torus_cam(2.0),
                   tt.init_state(cfg, device=CPU), 77, 2)
    assert int(st.rays) == int(float(st_j.rays)) == 117899
    _image_rule(tt.resolve_image(cfg, st).numpy(),
                np.asarray(tp.tpurt.resolve_image(cfg_j, st_j)))
    # the CPU runs the plain version: no G-leaf instance (GLEAF, the last
    # flag of the regen kernel's instances, true) ever launched
    assert not any(launcher.startswith("regen") and name.endswith("true>")
                   for launcher, name in mega_regen.INSTANCE_LAUNCHES)


def test_budget_mode_matches_tpurt_interpret(tp):
    """The budget mode with the flag against tpurt's render_budget_regen
    in interpret mode: 64x32, depth 3, K=2, 3 photon bounces, budgets
    0-3 from a fresh state."""
    kw = dict(width=64, height=32, depth=3, k_photons=2, max_photon_bounces=3,
              pallas_mxu_leaf=True, **WALK)
    cfg = tt.RenderConfig(**kw)
    st0 = tt.init_state(cfg, device=CPU)
    rows = st0.n_samples.shape[0]
    budgets = np.zeros((rows,), np.int64)
    budgets[:cfg.n_pixels] = np.random.default_rng(3).integers(
        0, 4, cfg.n_pixels)
    cfg_j = tp.tpurt.RenderConfig(**kw)
    _fresh_gmat_cache(tp)
    st_j = tp.regen.render_budget_regen(
        tp.tpurt.scene.torus_mesh_scene(8, 4), cfg_j,
        tp.tpurt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=2.0),
        tp.tpurt.init_state(cfg_j), 42, budgets.astype(np.int32), 3)
    st = mega_regen.render_budget_regen(
        tt.torus_mesh_scene(8, 4, device=CPU), cfg, _torus_cam(2.0), st0, 42,
        torch.from_numpy(budgets), 3)
    np.testing.assert_array_equal(st.n_samples.numpy(),
                                  np.asarray(st_j.n_samples))
    assert int(st.rays) == int(float(st_j.rays)) > 0
    n = cfg.n_pixels
    _image_rule(tt.resolve_image(cfg, st).numpy(),
                np.asarray(tp.tpurt.resolve_image(cfg_j, st_j)))
    assert st.rgb_sum[n:].abs().sum() == 0


# ----- (f) where tpurt keeps the exact leaf, the flag changes nothing -----

@pytest.mark.parametrize("case", ["xla", "tile-sync", "wavefront_fused",
                                  "chunked"])
def test_flag_changes_nothing_elsewhere(case):
    kw = {"xla": dict(backend="xla"),
          "tile-sync": dict(backend="pallas", pallas_regen=False),
          "wavefront_fused": dict(backend="wavefront_fused",
                                  enable_photons=False, wf_pool=512),
          "chunked": dict(backend="pallas", pallas_bvh_chunk=2048,
                          pallas_bvh_chunk_threshold=16)}[case]
    scene = tt.torus_mesh_scene(8, 4, device=CPU)
    cfg = tt.RenderConfig(width=32, height=16, depth=4, k_photons=2,
                          max_photon_bounces=3, pallas_static_unroll=8,
                          pallas_bvh_leaf=8, **kw)
    flag = cfg.with_(pallas_mxu_leaf=True)
    assert not bvh.mxu_leaf_engages(freeze_scene(scene), flag)
    cam = _torus_cam(2.0)
    a = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 9, 2)
    b = tt.render(scene, flag, cam, tt.init_state(flag, device=CPU), 9, 2)
    assert int(a.rays) == int(b.rays) > 0
    assert torch.equal(state_to_planes(a), state_to_planes(b))


def test_flag_engages_on_the_regen_path_and_needs_a_leaf_cap():
    """The regen path's plain version takes the G sweep (a different
    state from the exact leaf's here), and a G leaf without a leaf cap
    raises, as tpurt asserts."""
    scene = tt.torus_mesh_scene(8, 4, device=CPU)
    fs = freeze_scene(scene)
    cfg = tt.RenderConfig(width=32, height=16, depth=4, **WALK)
    flag = cfg.with_(pallas_mxu_leaf=True)
    tri = mega_regen.regen_tri_mode(fs, flag)
    assert tri.kind == "gleaf" and tri.gmat is bvh.gmat(fs, flag)
    assert mega_regen.regen_tri_mode(fs, cfg) is integrate.EXACT
    cam = _torus_cam(2.0)
    a = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 9, 1)
    b = tt.render(scene, flag, cam, tt.init_state(flag, device=CPU), 9, 1)
    assert not torch.equal(state_to_planes(a), state_to_planes(b))
    with pytest.raises(ValueError, match="pallas_bvh_leaf"):
        tt.render(scene, flag.with_(pallas_bvh_leaf=0), _torus_cam(2.0),
                  tt.init_state(flag, device=CPU), 1, 1)


# ----- (g) on the card: the G leaf against its plain version -----

def _g_probe_vs_plain(scene, cfg, o, d, tm, lam):
    before = bvh.LAUNCHES
    pairs = torch.zeros((1,), dtype=torch.int64, device=o.device)
    got = bvh.probe(scene, cfg, o, d, tm, lam, gleaf=True, pairs=pairs)
    assert bvh.LAUNCHES == before + 1 and int(pairs) > 0
    fs = freeze_scene(scene)
    tri = integrate.TriMode("gleaf", bvh.gmat(fs, cfg))
    t, loc, n, mat = integrate.intersect_scene(fs, tuple(o), tuple(d), tri)
    want = (t, torch.stack(loc), torch.stack(n), mat.int(),
            integrate._shadow(fs, tuple(o), tuple(d), tm, lam))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("width", [0, 8])
def test_g_probe_matches_plain_on_cuda(cuda, width):
    scene = tt.torus_mesh_scene(45, 45, device=cuda)
    cfg = tt.RenderConfig(backend="pallas", pallas_bvh_leaf=64,
                          pallas_bvh_width=width, pallas_mxu_leaf=True)
    rays = [torch.from_numpy(x).to(cuda) for x in _rays(scene, 65536, 11)]
    t = _g_probe_vs_plain(scene, cfg, *rays)
    assert (t < 1e29).float().mean() > 0.5


# bench config 6's sampler flags as tpurt ships them: the regen kernel's
# sampler instance
CONFIG6_SAMPLER = dict(photon_strata=16, photon_strata_dir=4096,
                       photon_strata_shared_k=True, photon_strata_bounce=True,
                       camera_strata_bounce=True, hero_wavelengths=4)


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["reference", "config6"])
@pytest.mark.parametrize("mode", ["uniform", "budget"])
def test_g_regen_kernel_matches_plain_on_cuda(cuda, mode, sampler):
    """The regen kernel's G instances (reference sampler and config 6's)
    against render_plain(_budget) with the G sweep: the same segments,
    every state plane bit for bit."""
    scene = tt.torus_mesh_scene(45, 45, device=cuda)
    fs = freeze_scene(scene)
    flags = CONFIG6_SAMPLER if sampler == "config6" else {}
    cfg = tt.RenderConfig(width=64, height=32, depth=8, backend="pallas",
                          pallas_bvh_leaf=64, pallas_mxu_leaf=True, **flags)
    cam = _torus_cam(2.0)
    st = tt.init_state(cfg, cuda)
    tri = mega_regen.regen_tri_mode(fs, cfg)
    gleaf = ("regen" if mode == "uniform" else "regen_budget",
             "regen_kernel<true, true>" if flags else
             "regen_kernel<false, true>")
    before = mega_regen.INSTANCE_LAUNCHES[gleaf]
    if mode == "uniform":
        planes = state_to_planes(st)
        pk, pp = planes.clone(), planes.clone()
        rk = int(mega_regen.regen_call(scene, cfg, cam, pk, 1234, 2, 0, 2.0,
                                       8))
        rp = int(integrate.render_plain(fs, cfg, cam, pp, 1234, 2, 0, 2.0,
                                        8, tri))
    else:
        b = torch.from_numpy(np.random.default_rng(5).integers(
            0, 4, st.n_samples.shape[0])).to(cuda)
        b[cfg.n_pixels:] = 0
        planes = state_to_planes(st)
        pk, pp = planes.clone(), planes.clone()
        rk = int(mega_regen.regen_budget_call(scene, cfg, cam, pk, 42, b,
                                              st.n_samples))
        rp = int(integrate.render_plain_budget(fs, cfg, cam, pp, 42, b,
                                               st.n_samples, tri))
    assert mega_regen.INSTANCE_LAUNCHES[gleaf] == before + 1
    assert rk == rp > 0
    assert torch.equal(pk, pp)
