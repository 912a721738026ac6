"""What a render call carries to the next: a state that a render call left
in its (16, P) planes (``render.resident_planes``) against the same calls
on contiguous copies of its fields (the packing path), and the regen
launcher's kept launch plan (``kernels.mega_regen.launch_plan``).

Everything is compared bit for bit: the two paths run the same kernels on
the same planes, and a plan hit must hold what a fresh build holds.

``python -m pytest tests/test_torch_plane_state.py -m gpu --noconftest``
runs the GPU cases where JAX is not installed.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import interop
from tpurt_torch.camera import MotionCamera
from tpurt_torch.kernels import mega_regen
from tpurt_torch.scene import freeze_scene

R = importlib.import_module("tpurt_torch.render")

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"

torch.set_num_threads(1)

CAM = dict(look_from=(0.0, 5.0, -12.0), look_at=(0.0, 5.0, 0.0), vfov=60.0)
PLANE_FIELDS = ("rgb_sum", "vis_pos", "vis_norm", "vis_wo", "vis_tp",
                "vis_mat")
BACKENDS = {"xla": dict(backend="xla"),
            "regen": dict(backend="pallas"),
            "tile_sync": dict(backend="pallas", pallas_regen=False)}
SCENES = {"cornell": lambda d: tt.cornell_spheres_scene(device=d),
          "mesh": lambda d: tt.torus_mesh_scene(nu=6, nv=4, device=d)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_plane_state.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _setup(backend="regen", scene="cornell", device=CPU, **kw):
    cfg = tt.RenderConfig(width=32, height=16, depth=4, k_photons=2,
                          max_photon_bounces=3, **BACKENDS[backend], **kw)
    cam = tt.make_camera(**CAM, aspect_ratio=2.0)
    return cfg, SCENES[scene](device), cam


def _packed(state):
    """The same state with each plane field a contiguous copy: the next
    call packs it."""
    return dataclasses.replace(state, **{
        f: getattr(state, f).contiguous().clone() for f in PLANE_FIELDS})


def _snapshot(state):
    return {f.name: (getattr(state, f.name).clone()
                     if isinstance(getattr(state, f.name), torch.Tensor)
                     else getattr(state, f.name))
            for f in dataclasses.fields(tt.RenderState)}


def _assert_equal(a, b):
    if isinstance(a, tt.RenderState):
        a, b = _snapshot(a), _snapshot(b)
    for name, x in a.items():
        y = b[name]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


def _chain(scene, cfg, cam, state, pack: bool):
    """Three 1-spp frames, then a 4-spp render, each on the state the last
    call returned (``pack``: on a contiguous copy of it)."""
    out = []
    for _ in range(3):
        state = tt.render_step(scene, cfg, cam,
                               _packed(state) if pack else state, 41)
        out.append(state)
    out.append(tt.render(scene, cfg, cam, _packed(state) if pack else state,
                         41, 4))
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_chain_equals_packing_path(backend, scene):
    """States and ray counts of a chain on plane-resident states equal the
    chain on packed copies, and no call writes its input."""
    cfg, sc, cam = _setup(backend, scene)
    kept = _chain(sc, cfg, cam, tt.init_state(cfg, device=CPU), pack=False)
    packed = _chain(sc, cfg, cam, tt.init_state(cfg, device=CPU), pack=True)
    for a, b in zip(kept, packed):
        _assert_equal(a, b)
        assert R.resident_planes(a) is not None
    assert kept[-1].iteration == 7 and int(kept[-1].rays) > 0
    before = _snapshot(kept[1])
    tt.render_step(sc, cfg, cam, kept[1], 5)
    _assert_equal(before, _snapshot(kept[1]))


def test_reuses_count_every_call_after_the_first():
    cfg, sc, cam = _setup()
    reuses, packs = R.PLANE_REUSES, R.PLANE_PACKS
    st = tt.init_state(cfg, device=CPU)
    for _ in range(4):
        st = tt.render_step(sc, cfg, cam, st, 3)
    assert (R.PLANE_REUSES - reuses, R.PLANE_PACKS - packs) == (3, 1)


def _replace_rgb(st):
    return dataclasses.replace(st, rgb_sum=st.rgb_sum.contiguous() + 0.0)


def _replace_vis_mat(st):
    return dataclasses.replace(st, vis_mat=st.vis_mat.clone())


def _write_vis_mat(st):
    st.vis_mat[:5] = 0
    return st


def _replace_scalars(st):
    return dataclasses.replace(st, iteration=st.iteration + 2)


@pytest.mark.parametrize("change,packs", [
    (_replace_rgb, 1), (_replace_vis_mat, 1), (_write_vis_mat, 1),
    (_replace_scalars, 0)], ids=["rgb_sum", "vis_mat", "vis_mat_written",
                                 "iteration"])
def test_changed_states_are_packed(change, packs):
    """A state whose fields no longer all come from one call's planes is
    packed, and renders as its contiguous copy does; one whose plane
    fields are untouched is copied whole."""
    cfg, sc, cam = _setup()
    st = change(tt.render_step(sc, cfg, cam, tt.init_state(cfg, device=CPU),
                               9))
    want = tt.render_step(sc, cfg, cam, _packed(st), 9)
    n = R.PLANE_PACKS
    got = tt.render_step(sc, cfg, cam, st, 9)
    assert R.PLANE_PACKS - n == packs
    _assert_equal(got, want)


def test_written_vis_mat_reaches_the_planes():
    """An in-place write to a plane-resident vis_mat is what the next call
    reads: the planes it packs hold the written ids."""
    cfg, sc, cam = _setup()
    st = tt.render_step(sc, cfg, cam, tt.init_state(cfg, device=CPU), 9)
    st.vis_mat[:7] = 2
    planes = R.state_to_planes(st)
    assert torch.equal(planes[15, :7], torch.full((7,), 2.0))
    assert torch.equal(planes, R.state_to_planes(_packed(st)))


def test_budget_regen_returns_plane_resident_state():
    """``render_budget_regen`` unpacks through ``plane_fields``: its state
    is plane-resident and equals the budget call on a packed copy."""
    cfg, sc, cam = _setup()
    st = tt.render_step(sc, cfg, cam, tt.init_state(cfg, device=CPU), 2)
    budgets = torch.zeros_like(st.n_samples, dtype=torch.int64)
    budgets[:cfg.n_pixels] = torch.arange(cfg.n_pixels) % 3
    got = mega_regen.render_budget_regen(sc, cfg, cam, st, 2, budgets, 2)
    want = mega_regen.render_budget_regen(sc, cfg, cam, _packed(st), 2,
                                          budgets, 2)
    _assert_equal(got, want)
    assert R.resident_planes(got) is not None


def _consumers():
    def checkpoint(cfg, st, tmp_path):
        path = str(tmp_path / "ck.npz")
        tt.save_checkpoint(path, cfg, st)
        cfg2, loaded = tt.load_checkpoint(path, device=CPU)
        assert cfg2 == cfg
        return _snapshot(loaded)

    def to_numpy(cfg, st, tmp_path):
        out = interop.state_to_numpy(st)
        assert all(v.flags.c_contiguous for v in out.values())
        return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}

    def wavefront(cfg, st, tmp_path):
        wf = cfg.with_(backend="wavefront", enable_photons=False,
                       wf_pool=512)
        sc = tt.cornell_spheres_scene(device=CPU)
        cam = tt.make_camera(**CAM, aspect_ratio=2.0)
        return _snapshot(tt.render(sc, wf, cam, st, 4, 1))

    return {
        "resolve_image": lambda cfg, st, _: {
            "img": tt.resolve_image(cfg, st)},
        "resolve_radiance": lambda cfg, st, _: {
            "rad": tt.resolve_radiance(cfg, st)},
        "checkpoint": checkpoint, "state_to_numpy": to_numpy,
        "wavefront": wavefront}


@pytest.mark.parametrize("consumer", sorted(_consumers()))
def test_consumers_accept_plane_resident_states(consumer, tmp_path):
    cfg, sc, cam = _setup()
    st = tt.render(sc, cfg, cam, tt.init_state(cfg, device=CPU), 6, 2)
    assert R.resident_planes(st) is not None
    fn = _consumers()[consumer]
    _assert_equal(fn(cfg, st, tmp_path), fn(cfg, _packed(st), tmp_path))


# ----- the launch plan -----

def _plan(scene, cfg, cam):
    return mega_regen.launch_plan(freeze_scene(scene), cfg, cam, CPU,
                                  mega_regen.PHOTON)


def test_plan_repeat_call_hits():
    cfg, sc, cam = _setup()
    hits, builds = mega_regen.PLAN_HITS, mega_regen.PLAN_BUILDS
    first = _plan(sc, cfg, cam)
    again = _plan(sc, cfg.with_(), tt.make_camera(**CAM, aspect_ratio=2.0))
    assert again is first
    assert (mega_regen.PLAN_HITS - hits,
            mega_regen.PLAN_BUILDS - builds) == (1, 1)


@pytest.mark.parametrize("change", ["camera", "config", "scene"])
def test_plan_builds_anew(change):
    cfg, sc, cam = _setup()
    first = _plan(sc, cfg, cam)
    if change == "camera":
        cam = tt.make_camera((0.0, 5.0, -11.0), CAM["look_at"], vfov=60.0,
                             aspect_ratio=2.0)
    elif change == "config":
        cfg = cfg.with_(k_photons=3)
    else:
        sc = tt.cornell_spheres_scene(device=CPU)
    builds = mega_regen.PLAN_BUILDS
    other = _plan(sc, cfg, cam)
    assert other is not first and mega_regen.PLAN_BUILDS == builds + 1
    if change == "camera":
        assert torch.equal(other.table[12:], first.table[12:])
        assert not torch.equal(other.table[:12], first.table[:12])
    if change == "config":
        assert other.photons == 3 and first.photons == 2


def test_camera_key_reads_the_rows():
    """The key is the rows' bytes, whatever the rows' strides; a
    MotionCamera's key holds both poses."""
    cam = tt.make_camera(**CAM, aspect_ratio=2.0)
    assert mega_regen.camera_key(cam) == cam.rows().tobytes()
    cols = torch.from_numpy(cam.rows().T.copy()).T     # strided rows
    strided = tt.Camera(*cols.unbind(0))
    assert not strided.origin.is_contiguous()
    assert mega_regen.camera_key(strided) == mega_regen.camera_key(cam)
    moved = tt.make_camera((0.5, 5.0, -12.0), CAM["look_at"], vfov=60.0,
                           aspect_ratio=2.0)
    assert mega_regen.camera_key(MotionCamera(cam, moved)) \
        == cam.rows().tobytes() + moved.rows().tobytes()
    assert mega_regen.camera_key(None) == b""


def test_plan_keeps_a_bounded_number():
    """An orbiting camera builds a plan a frame and keeps the last
    PLAN_LIMIT."""
    cfg, sc, cam = _setup()
    fs = freeze_scene(sc)
    for i in range(3 * mega_regen.PLAN_LIMIT):
        a = 0.3 * i
        mega_regen.launch_plan(fs, cfg, tt.make_camera(
            (12.0 * np.sin(a), 5.0, -12.0 * np.cos(a)), CAM["look_at"],
            vfov=60.0, aspect_ratio=2.0), CPU, mega_regen.PHOTON)
    assert len(fs.cache["plans"]) == mega_regen.PLAN_LIMIT


def _struct(s):
    if s is None:
        return None
    out = {}
    for name, *_ in s._fields_:
        v = getattr(s, name)
        out[name] = list(v) if hasattr(v, "_length_") else v
    return out


def _plan_fields(plan):
    return {"table": plan.table, "geo": id(plan.geo),
            "tri": (plan.tri.kind, id(plan.tri.gmat)),
            "geo_args": _struct(plan.geo_args),
            "sampler": _struct(plan.sampler),
            "emission": _struct(plan.emission),
            "spawn": _struct(plan.spawn), "lights": _struct(plan.lights),
            "photons": plan.photons, "cie": plan.cie, "lib": plan.lib,
            "instances": plan.instances}


PLAN_CASES = {
    "default": {},
    "sampler_emission": dict(photon_strata=8, hero_wavelengths=4,
                             sky_intensity=0.5),
    "spawn": dict(qmc=True, aperture=0.2, focus_dist=10.0,
                  photon_rr_scale=0.5),
    "lights": dict(light_sample="power", photon_aim=0.5),
    "motion": dict(motion_blur=True),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_hit_equals_fresh_build(case):
    cfg, sc, cam = _setup(**PLAN_CASES[case])
    if cfg.motion_blur:
        cam = MotionCamera(cam, tt.make_camera(
            (0.5, 5.0, -12.0), CAM["look_at"], vfov=60.0, aspect_ratio=2.0))
    fs = freeze_scene(sc)
    mega_regen.launch_plan(fs, cfg, cam, CPU, mega_regen.PHOTON)
    hit = mega_regen.launch_plan(fs, cfg, cam, CPU, mega_regen.PHOTON)
    _assert_equal(_plan_fields(hit), _plan_fields(
        mega_regen.build_plan(fs, cfg, cam, CPU, mega_regen.PHOTON)))
    if case != "default":
        assert any(s is not None
                   for s in (hit.emission, hit.spawn, hit.lights))


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_camera_plan_holds_what_the_wavefront_launchers_built(case):
    """A CAMERA plan holds, field for field, the table, geometry and
    switches the fused and sweep launchers built for themselves on every
    call or render: the camera-path sampler, the wavefront emission, spawn
    switches without photons, the NEE mode alone, the exact triangle test.
    A second launch_plan call is a hit."""
    cfg, sc, cam = _setup(enable_photons=False, **PLAN_CASES[case])
    if cfg.motion_blur:
        cam = MotionCamera(cam, tt.make_camera(
            (0.5, 5.0, -12.0), CAM["look_at"], vfov=60.0, aspect_ratio=2.0))
    fs = freeze_scene(sc)
    plan = mega_regen.launch_plan(fs, cfg, cam, CPU, mega_regen.CAMERA)
    table, geo = mega_regen.scene_table(fs, cfg, cam, CPU)
    _assert_equal({k: v for k, v in _plan_fields(plan).items()
                   if k not in ("tri", "instances")}, {
        "table": table, "geo": id(geo),
        "geo_args": _struct(geo.args()),
        "sampler": _struct(mega_regen.camera_sampler_args(fs, cfg)),
        "emission": _struct(mega_regen.emission_args(fs, cfg,
                                                     wavefront=True)),
        "spawn": _struct(mega_regen.spawn_args(cfg, cam, CPU,
                                               photons=False)),
        "lights": _struct(mega_regen.lights_args(cfg, photons=False)),
        "photons": 0, "cie": mega_regen.cie_table(CPU).data_ptr(),
        "lib": None})
    assert plan.tri.gmat is None and plan.geo_args.gmat is None
    assert set(plan.instances) == {"wf_fused", "wf_fused_budget", "wf_sweep"}
    hits, builds = mega_regen.PLAN_HITS, mega_regen.PLAN_BUILDS
    assert mega_regen.launch_plan(fs, cfg, cam, CPU,
                                  mega_regen.CAMERA) is plan
    assert (mega_regen.PLAN_HITS - hits,
            mega_regen.PLAN_BUILDS - builds) == (1, 0)
    photon = mega_regen.launch_plan(fs, cfg, cam, CPU, mega_regen.PHOTON)
    assert photon is not plan and mega_regen.PLAN_BUILDS == builds + 1


def _bad_calls():
    cfg, _, cam = _setup()
    motion = MotionCamera(cam, cam)
    return {
        "depth": (ValueError, "depth must be", dict(depth=0)),
        "pixels": (ValueError, "pixels, cfg pads", dict(
            state=tt.init_state(cfg.with_(height=64), device=CPU))),
        "knob": (NotImplementedError, "count_iters", dict(
            cfg=cfg.with_(count_iters=True))),
        "light_sample": (ValueError, "light_sample", dict(
            cfg=cfg.with_(light_sample="nearest"))),
        "needs_motion": (TypeError, "MotionCamera", dict(
            cfg=cfg.with_(motion_blur=True))),
        "motion_camera": (TypeError, "motion_blur is False", dict(
            cam=motion)),
        "camera_strata": (ValueError, "camera", dict(cfg=cfg.with_(
            backend="wavefront", enable_photons=False,
            photon_strata=8, camera_strata_bounce=True))),
        "device": (ValueError, "scene on", dict(state=dataclasses.replace(
            tt.init_state(cfg, device=CPU),
            rgb_sum=torch.zeros((4096, 3), device="meta")))),
    }


@pytest.mark.parametrize("bad", sorted(_bad_calls()))
def test_check_call_raises_each_time(bad):
    """Each check raises its error, with its message, on every call of
    the same bad arguments."""
    exc, match, over = _bad_calls()[bad]
    cfg, sc, cam = _setup()
    kw = {**dict(cfg=cfg, cam=cam, state=tt.init_state(cfg, device=CPU),
                 depth=cfg.depth), **over}
    for _ in range(2):
        with pytest.raises(exc, match=match):
            R._check_call(sc, kw["cfg"], kw["cam"], kw["state"], kw["depth"])


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["regen", "tile_sync"])
def test_kernel_chain_equals_packing_path(cuda, backend):
    """On the card: the kernel's chain on plane-resident states against
    packed copies, bit for bit, with the blit; plans hit after the first
    call."""
    cfg, sc, cam = _setup(backend, device=cuda)
    cfg = cfg.with_(width=96, height=64)
    hits = mega_regen.PLAN_HITS
    kept = _chain(sc, cfg, cam, tt.init_state(cfg, device=cuda), pack=False)
    packed = _chain(sc, cfg, cam, tt.init_state(cfg, device=cuda), pack=True)
    for a, b in zip(kept, packed):
        _assert_equal(a, b)
        assert torch.equal(tt.resolve_image(cfg, a), tt.resolve_image(cfg, b))
    assert mega_regen.PLAN_HITS - hits >= 2 * (3 + (4 if backend ==
                                                     "tile_sync" else 1)) - 1
