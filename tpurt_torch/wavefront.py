"""The wavefront path tracer of the port (``tpurt/wavefront.py``): a
persistent pool of Q ray slots, refilled by regeneration.

Each sweep: dead slots claim the next pending (pixel, sample) work items
and become fresh camera rays (``_regen``/``_issue``); every active slot
takes one bounce (``_sweep``: nearest hit, NEE over every light,
scatter + Russian roulette, the depth gate); slots whose paths ended add
their radiance into the image (the splat, ``index_add_``). The loop ends
when no work is pending and the pool has drained, or after
``cfg.wf_max_sweeps`` sweeps; the loop test reads one flag from the device
per sweep.

Camera paths only: the photon pass and the vispoints are left as they are
(``enable_photons`` is ignored, as in tpurt's wavefront tracers). Work
items are the same per-(pixel, sample) PCG streams as every other backend,
so ray counts equal the progressive renderer's with photons off.

This module is ``backend="wavefront"``. ``_sweep`` is also the plain
version of the sweep kernel (``kernels/wavefront_sweep.py``, which drives
this pool through ``wavefront_render_slab(..., sweep=...)``), and
``wavefront_render`` the plain version of the fused kernel
(``kernels/wavefront_fused.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from tpurt_torch.camera import spawn_camera_rays
from tpurt_torch.config import check_slice
from tpurt_torch.integrate import (_material_kinds, intersect_scene,
                                   light_emission_rgb, material_lookup,
                                   material_table, sample_direct_lighting,
                                   scatter_and_rr)
from tpurt_torch.ops import fdiv
from tpurt_torch.ops import soa as s
from tpurt_torch.ops.intersect import HIT
from tpurt_torch.ops.rng import frame_seed, rand_1f, seed_pixels
from tpurt_torch.ops.spectra import sample_wavelength
from tpurt_torch.scene import freeze_scene

# f32 plane bases of the pool (each vec3 takes 3 planes), i32 plane rows
O, D, TP, RAD, LAM = 0, 3, 6, 9, 12
N_F = 13
PIX, BOUNCE, ACTIVE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class WavefrontPool:
    """The ray pool in planes (Q slots), the layout the sweep kernel reads.
    Fields of tpurt's ``WavefrontPool``: ``pf`` holds o, d, tp, rad, lam,
    ``pi`` pix (the state row the path adds into), bounce, active (0/1),
    ``rng`` the PCG state (a uint32 held in int64, as in ``ops.rng``)."""
    pf: torch.Tensor    # (13, Q) f32
    pi: torch.Tensor    # (3, Q)  i32
    rng: torch.Tensor   # (Q,)    i64

    @property
    def active(self) -> torch.Tensor:
        return self.pi[ACTIVE] != 0


def new_pool(q: int, device) -> WavefrontPool:
    """An empty pool: every slot dead."""
    return WavefrontPool(
        pf=torch.zeros((N_F, q), dtype=torch.float32, device=device),
        pi=torch.zeros((3, q), dtype=torch.int32, device=device),
        rng=torch.zeros((q,), dtype=torch.int64, device=device))


def reject_camera_strata(cfg) -> None:
    """The wavefront tracers draw the unstratified camera scatter sequence
    (``tpurt.wavefront.reject_camera_strata``)."""
    if cfg.camera_strata_bounce:
        raise ValueError(
            "camera_strata_bounce is not implemented by the wavefront "
            "tracers: disable it for wavefront backends")


def _issue(cfg, camera, pool: WavefrontPool, pix, gpix, seed_iter,
           have_work, base_seed: int) -> WavefrontPool:
    """Turn the claimed work items into fresh camera rays in the dead slots
    ``have_work``: ``pix`` is the state row, ``gpix`` the global pixel (they
    differ only for a slab), ``seed_iter`` the per-slot sample iteration.
    Draws: 2 jitter, 1 wavelength, from seed_pixels(frame_seed(base_seed,
    seed_iter), px, py), as every backend draws a camera spawn."""
    px = gpix % cfg.width
    py = gpix // cfg.width
    rng = seed_pixels(frame_seed(base_seed, seed_iter), px, py)
    uj1, rng = rand_1f(rng)
    uj2, rng = rand_1f(rng)
    u = fdiv(px.to(torch.float32) + uj1, float(cfg.width))
    v = fdiv(py.to(torch.float32) + uj2, float(cfg.height))
    o, d, rng = spawn_camera_rays(cfg, camera, u, v, rng)
    ulam, rng = rand_1f(rng)
    lam = sample_wavelength(ulam)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    fresh = (*o, *d, one, one, one, zero, zero, zero, lam)
    pf = torch.stack([torch.where(have_work, new, old)
                      for new, old in zip(fresh, pool.pf)])
    pi = torch.stack([
        torch.where(have_work, pix.to(torch.int32), pool.pi[PIX]),
        torch.where(have_work, 0, pool.pi[BOUNCE]),
        torch.where(have_work, 1, pool.pi[ACTIVE])]).to(torch.int32)
    return WavefrontPool(pf=pf, pi=pi,
                         rng=torch.where(have_work, rng, pool.rng))


def _regen(cfg, camera, pool: WavefrontPool, next_sample, next_pix, spp: int,
           base_seed: int, it0: int, pix_offset: int, n_valid: int):
    """Refill dead slots with the next pending (pixel, sample) work items,
    enumerated pixel-major as the counter pair (next_sample, next_pix) of
    int64 device scalars, as tpurt keeps it. Sample s of a pixel draws
    from iteration it0 + s. Returns (pool, next_sample, next_pix)."""
    n_pix = max(n_valid, 1)   # an all-padding slab has no work
    dead = ~pool.active
    rank = torch.cumsum(dead, 0) - 1       # rank among dead slots
    p = next_pix + rank
    sample = next_sample + p // n_pix
    pix = p % n_pix
    have_work = dead & (sample < spp) & (n_valid > 0)
    pool = _issue(cfg, camera, pool, pix, pix_offset + pix, it0 + sample,
                  have_work, base_seed)
    np2 = next_pix + have_work.sum()
    return pool, next_sample + np2 // n_pix, np2 % n_pix


def _sweep(fs, cfg, pool: WavefrontPool):
    """One extend+shade sweep over the whole pool: the plain version of the
    sweep kernel. Returns (pool, terminated (Q,) bool, traced segments as an
    int64 scalar). Terminated slots keep their pix and rad for the splat;
    inactive slots keep their PCG state and count a bounce, as in the
    kernel."""
    mats = material_table(fs, pool.pf.device)
    pf = pool.pf
    o, d, tp, rad = (tuple(pf[b + c] for c in range(3))
                     for b in (O, D, TP, RAD))
    lam = pf[LAM]
    active = pool.active
    bounce = pool.pi[BOUNCE]
    rays = active.sum()

    t, loc, n, mat = intersect_scene(fs, o, d)
    found = t < HIT
    color, rough, ior, is_diffuse, is_metal = material_lookup(mats, mat)
    wo = s.vneg(d)
    em = light_emission_rgb(fs, lam)
    direct, rng = sample_direct_lighting(fs, loc, n, lam, pool.rng, em)
    lane_d = active & found & is_diffuse
    nee = s.vmul(s.vmul(tp, color), direct)
    rad = s.vwhere(lane_d, s.vadd(rad, nee), rad)
    rays = rays + lane_d.sum() * len(fs.lights)

    any_diel, any_metal = _material_kinds(fs)
    wi, new_tp, new_o, scat_ok, rr_live, rng = scatter_and_rr(
        cfg, wo, n, loc, color, rough, ior, is_diffuse, is_metal, tp, rng,
        camera_path=True, any_dielectric=any_diel, any_metal=any_metal)
    cont = active & found & scat_ok & rr_live & (bounce + 1 < cfg.depth)
    terminated = active & ~cont

    pf_new = torch.stack([*s.vwhere(cont, new_o, o), *s.vwhere(cont, wi, d),
                          *s.vwhere(cont, new_tp, tp), *rad, lam])
    pi_new = torch.stack([pool.pi[PIX], bounce + 1,
                          cont.to(torch.int32)]).to(torch.int32)
    return (WavefrontPool(pf=pf_new, pi=pi_new,
                          rng=torch.where(active, rng, pool.rng)),
            terminated, rays)


def _drain(fs, cfg, state, regen, pending, sweep):
    """The sweep loop shared by the uniform and the budget renderers, over
    a pool of cfg.wf_pool slots: while work is ``pending()`` (a device
    bool) or a slot is active, and at most cfg.wf_max_sweeps times,
    ``regen(pool)`` refills dead slots, ``sweep`` takes one bounce and the
    terminated slots splat into rgb_sum and n_samples. Returns (rgb_sum,
    n_samples, rays)."""
    pool = new_pool(cfg.wf_pool, state.device)
    rgb = state.rgb_sum.clone()
    ns = state.n_samples.clone()
    rays = torch.zeros((), dtype=torch.int64, device=rgb.device)
    sweeps = 0
    while sweeps < cfg.wf_max_sweeps:
        if not bool(pending() | pool.active.any()):
            break
        pool = regen(pool)
        pool, term, nrays = sweep(fs, cfg, pool)
        pix = pool.pi[PIX].long()
        rgb.index_add_(0, pix, torch.where(term[:, None],
                                           pool.pf[RAD:RAD + 3].T, 0.0))
        ns.index_add_(0, pix, term.to(torch.float32))
        rays = rays + nrays
        sweeps += 1
    return rgb, ns, rays


def _check_state(state, scene) -> None:
    if scene.device != state.device:
        raise ValueError(f"scene on {scene.device}, state on {state.device}: "
                         f"move one with .to(device)")


def wavefront_render_slab(scene, cfg, camera, state, base_seed, spp: int,
                          pix_offset: int, n_valid: int, sweep=None):
    """``wavefront_render`` over one pixel slab: ``state`` holds the slab's
    rows, pixel ids are slab-local, RNG and camera use the global pixel
    ``pix_offset + row``. ``sweep`` is the sweep function, ``_sweep`` by
    default; the sweep kernel's wrapper takes its place for
    ``backend="wavefront_pallas"``."""
    reject_camera_strata(cfg)
    check_slice(cfg)
    _check_state(state, scene)
    sweep = _sweep if sweep is None else sweep
    fs = freeze_scene(scene)
    dev = state.device
    spp, base_seed = int(spp), int(base_seed)
    next_sample = torch.zeros((), dtype=torch.int64, device=dev)
    next_pix = torch.zeros((), dtype=torch.int64, device=dev)

    def regen(pool):
        nonlocal next_sample, next_pix
        pool, next_sample, next_pix = _regen(
            cfg, camera, pool, next_sample, next_pix, spp, base_seed,
            state.iteration, pix_offset, n_valid)
        return pool

    def pending():
        return (next_sample < spp) & (n_valid > 0)

    rgb, ns, rays = _drain(fs, cfg, state, regen, pending, sweep)
    return dataclasses.replace(
        state, rgb_sum=rgb, n_samples=ns, iteration=state.iteration + spp,
        rays=state.rays + rays if cfg.count_rays else state.rays)


def wavefront_render(scene, cfg, camera, state, base_seed, spp: int):
    """Render ``spp`` samples per pixel through the persistent pool into
    the same RenderState as every backend (vispoints and photon radius
    untouched; ``iteration`` grows by ``spp``)."""
    return wavefront_render_slab(scene, cfg, camera, state, base_seed, spp,
                                 0, cfg.n_pixels)
