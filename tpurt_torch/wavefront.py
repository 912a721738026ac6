"""The wavefront path tracer of the port (``tpurt/wavefront.py``): a
persistent pool of Q ray slots, refilled by regeneration.

Each sweep (``_step``): dead slots claim the next pending work items and
become fresh camera rays (``_claim``: ``_regen`` for the uniform
(pixel, sample) enumeration, ``_regen_budget`` for adaptive sampling's
round-major one); every active slot takes one bounce (``_sweep``: nearest
hit, NEE over every light or, under light_sample "power" or "spatial",
one light the slot selects, scatter + Russian roulette, the depth gate);
slots whose paths ended add their radiance into the image (the splat);
then the loop's control words advance and the loop test of the next sweep
is evaluated, all on the device. The loop ends when no work is pending and
the pool has drained, or after ``cfg.wf_max_sweeps`` sweeps. The host
enqueues sweeps in batches and reads the test once per batch
(``_pool_live``); a sweep past the end changes nothing, so the result is
the one of a read per sweep. The step hook sets the batch: one sweep for
the plain step, whose sweeps past the end would each cost a whole sweep,
and ``kernels/wavefront_sweep.py SWEEP_BATCH`` for the kernel, whose
launches past the end return at once.

Camera paths only: the photon pass and the vispoints are left as they are
(``enable_photons`` is ignored, as in tpurt's wavefront tracers). Work
items are the same per-(pixel, sample) PCG streams as every other backend,
so ray counts equal the progressive renderer's with photons off. tpurt's
sampler runs here as on the path kernels, but for the photon flags (no
photons) and the camera strata (rejected, as in tpurt): hero wavelengths
average the lights', the sky's and the emitters' emission, and a slot
whose path meets a dielectric under camera-path dispersion collapses to
its hero wavelength (a bit of the slot's state word, kept with its active
flag). A miss adds the sky, or under ``sky_gradient`` alone tpurt's legacy
RGB ramp (the path kernels ignore sky_gradient alone, as tpurt's do); an
emissive hit adds its emission and ends the path; the splat caps each
path at ``radiance_clamp``.

This module is ``backend="wavefront"``. ``_step`` is also the plain
version of the sweep kernel (``kernels/wavefront_sweep.py``, a whole sweep
in one launch, which drives this pool through
``wavefront_render_slab(..., step=...)``), and ``wavefront_render`` the
plain version of the fused kernel (``kernels/wavefront_fused.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import torch

from tpurt_torch.camera import check_camera
from tpurt_torch.config import check_slice
from tpurt_torch.integrate import (BVH, EXACT, TriMode, _material_kinds,
                                   add_emitters, add_sky, camera_emission,
                                   clamp_sample, intersect_scene, is_emitter,
                                   material_lookup, material_table,
                                   sample_direct_lighting, scatter_and_rr,
                                   shadow_segments, spawn_camera,
                                   tracks_collapse)
from tpurt_torch.ops import fdiv
from tpurt_torch.ops import soa as s
from tpurt_torch.ops.intersect import HIT
from tpurt_torch.ops.rng import frame_seed
from tpurt_torch.ops.spectra import DISPERSION_B
from tpurt_torch.scene import freeze_scene

# f32 plane bases of the pool (each vec3 takes 3 planes), i32 plane rows
O, D, TP, RAD, LAM = 0, 3, 6, 9, 12
N_F = 13
PIX, BOUNCE, ACTIVE = 0, 1, 2
# the ACTIVE row is the slot's state word: 0 dead, else 1 | COLLAPSED when
# its path has collapsed to its hero wavelength
COLLAPSED = 2
# The pool loop's control words, int64 on the pool's device: sweeps taken,
# the next work item (next_sample, or next_work in budget mode), next_pix
# (uniform mode), the loop test of the next sweep (0/1), traced segments.
# The sweep kernel's words for one launch follow, zero between launches:
# up to CTL_WORDS, then one per POOL_CHUNK slots.
SWEEPS, NEXT, NEXT_PIX, GO, RAYS = 0, 1, 2, 3, 4
CTL_WORDS = 9
POOL_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class WavefrontPool:
    """The ray pool in planes (Q slots), the layout the sweep kernel reads.
    Fields of tpurt's ``WavefrontPool``: ``pf`` holds o, d, tp, rad, lam,
    ``pi`` pix (the state row the path adds into), bounce, and the state
    word (0 dead; 1 active, plus COLLAPSED for tpurt's ``coll``), ``rng``
    the PCG state (a uint32 held in int64, as in ``ops.rng``)."""
    pf: torch.Tensor    # (13, Q) f32
    pi: torch.Tensor    # (3, Q)  i32
    rng: torch.Tensor   # (Q,)    i64

    @property
    def active(self) -> torch.Tensor:
        return self.pi[ACTIVE] != 0

    @property
    def coll(self) -> torch.Tensor:
        """tpurt's collapse bit: the slot's path carries its hero
        wavelength alone."""
        return (self.pi[ACTIVE] & COLLAPSED) != 0


def new_pool(q: int, device) -> WavefrontPool:
    """An empty pool: every slot dead."""
    return WavefrontPool(
        pf=torch.zeros((N_F, q), dtype=torch.float32, device=device),
        pi=torch.zeros((3, q), dtype=torch.int32, device=device),
        rng=torch.zeros((q,), dtype=torch.int64, device=device))


def new_ctl(q: int, go, device) -> torch.Tensor:
    """The control words of a fresh loop over a pool of q slots: nothing
    claimed, no sweep taken, the loop test ``go`` (a bool or a device
    bool)."""
    ctl = torch.zeros((CTL_WORDS + -(-q // POOL_CHUNK),), dtype=torch.int64,
                      device=device)
    ctl[GO] = go
    return ctl


@dataclasses.dataclass(frozen=True)
class PoolWork:
    """The work items of a pool render and how a claimed one becomes a
    camera ray. Uniform (``cum`` None): pixel-major (sample, pixel) items,
    ``spp`` samples for each of the slab's ``n_valid`` rows from iteration
    ``it0``. Budget: round-major items over per-pixel budgets
    (``adaptive._round_major_tables``: ``order``, ``cum``), pixel p's
    round-s sample from iteration ``base_counts[p] + s``. The RNG and the
    camera take the global pixel ``pix_offset + row``."""
    camera: object
    base_seed: int
    pix_offset: int = 0
    spp: int = 0
    it0: int = 0
    n_valid: int = 0
    order: torch.Tensor | None = None
    cum: torch.Tensor | None = None
    base_counts: torch.Tensor | None = None

    def pending(self, nxt: torch.Tensor) -> torch.Tensor:
        """Whether work is left from item counter ``nxt`` (a device
        bool)."""
        if self.cum is None:
            return (nxt < self.spp) & (self.n_valid > 0)
        return nxt < self.cum[-1]


def reject_camera_strata(cfg) -> None:
    """The wavefront tracers draw the unstratified camera scatter sequence
    (``tpurt.wavefront.reject_camera_strata``)."""
    if cfg.camera_strata_bounce:
        raise ValueError(
            "camera_strata_bounce is not implemented by the wavefront "
            "tracers: disable it for wavefront backends")


def check_sampler(cfg) -> None:
    """The sampler flags the wavefront tracers take: all of them but the
    camera strata, which raise as in tpurt. Photon strata need no check:
    these tracers trace no photons, in tpurt as here."""
    reject_camera_strata(cfg)


def _issue(cfg, camera, pool: WavefrontPool, pix, gpix, seed_iter,
           have_work, base_seed: int) -> WavefrontPool:
    """Turn the claimed work items into fresh camera rays in the dead slots
    ``have_work``: ``pix`` is the state row, ``gpix`` the global pixel (they
    differ only for a slab), ``seed_iter`` the per-slot sample iteration.
    The spawn (``integrate.spawn_camera``) draws from seed_pixels(
    frame_seed(base_seed, seed_iter), px, py), as every backend draws a
    camera spawn; under qmc from the Sobol stream of sample ``seed_iter``.
    A fresh ray's state word is 1: active, not collapsed."""
    px = gpix % cfg.width
    py = gpix // cfg.width
    o, d, lam, rng = spawn_camera(cfg, camera, px, py,
                                  frame_seed(base_seed, seed_iter),
                                  (base_seed, seed_iter))
    one, zero = torch.ones_like(lam), torch.zeros_like(lam)
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


def _sweep(fs, cfg, pool: WavefrontPool, tri: TriMode = EXACT):
    """One extend+shade sweep over the whole pool: the plain version of the
    sweep kernel; ``tri`` is the nearest hit's triangle test. A miss adds
    the sky (or the legacy ramp), an emissive hit its emission; NEE adds
    the lights' emission, hero-averaged until the slot collapses. Returns
    (pool, terminated (Q,) bool, traced segments as an int64 scalar).
    Terminated slots keep their pix and rad for the splat; inactive slots
    keep their PCG state and count a bounce, as in the kernel."""
    mats = material_table(fs, pool.pf.device)
    pf = pool.pf
    o, d, tp, rad = (tuple(pf[b + c] for c in range(3))
                     for b in (O, D, TP, RAD))
    lam = pf[LAM]
    active = pool.active
    coll = pool.coll
    bounce = pool.pi[BOUNCE]
    rays = active.sum()

    t, loc, n, mat = intersect_scene(fs, o, d, tri)
    found = t < HIT
    color, rough, ior, is_diffuse, is_metal = material_lookup(mats, mat)
    is_em = is_emitter(mats, mat)
    wo = s.vneg(d)
    em, em_hero, emit = camera_emission(fs, cfg, lam, wavefront=True)
    rad = add_sky(cfg, emit, rad, tp, d, active & ~found, coll)
    rad = add_emitters(emit, rad, tp, color, active & found & is_em, coll)
    if em_hero is not None:
        em = [s.vwhere(coll, h, a) for h, a in zip(em_hero, em)]
    direct, rng = sample_direct_lighting(fs, loc, n, lam, pool.rng, em,
                                         cfg.light_sample)
    lane_d = active & found & is_diffuse
    nee = s.vmul(s.vmul(tp, color), direct)
    rad = s.vwhere(lane_d, s.vadd(rad, nee), rad)
    rays = rays + lane_d.sum() * shadow_segments(fs, cfg)

    any_diel, any_metal = _material_kinds(fs)
    eta = ior
    if cfg.dispersion_in_camera_path:
        lam_um = lam * 1e-3
        eta = ior + fdiv(DISPERSION_B, lam_um * lam_um)
    wi, new_tp, new_o, scat_ok, rr_live, rng = scatter_and_rr(
        cfg, wo, n, loc, color, rough, eta, is_diffuse, is_metal, tp, rng,
        camera_path=True, any_dielectric=any_diel, any_metal=any_metal)
    cont = (active & found & scat_ok & rr_live & (bounce + 1 < cfg.depth)
            & ~is_em)
    terminated = active & ~cont
    if tracks_collapse(fs, cfg):
        # a dielectric steers the path by eta(lam): only the hero goes on
        coll = coll | (active & found & ~(is_diffuse | is_metal | is_em))

    pf_new = torch.stack([*s.vwhere(cont, new_o, o), *s.vwhere(cont, wi, d),
                          *s.vwhere(cont, new_tp, tp), *rad, lam])
    state = torch.where(cont, torch.where(coll, 1 | COLLAPSED, 1), 0)
    pi_new = torch.stack([pool.pi[PIX], bounce + 1,
                          state]).to(torch.int32)
    return (WavefrontPool(pf=pf_new, pi=pi_new,
                          rng=torch.where(active, rng, pool.rng)),
            terminated, rays)


def _regen_budget(cfg, camera, pool, next_work, base_seed: int, base_counts,
                  order, cum, total, pix_offset: int):
    """Refill dead slots from the round-major budgeted work stream; pixel
    p's round-s sample draws from iteration base_counts[p] + s. Returns
    (pool, next_work)."""
    dead = ~pool.active
    w = next_work + torch.cumsum(dead, 0) - 1
    rnd = torch.searchsorted(cum, w, right=True)
    s_safe = rnd.clamp_max(cum.shape[0] - 1)
    start = torch.where(rnd > 0, cum[(s_safe - 1).clamp_min(0)], 0)
    r = w - start
    have_work = dead & (w < total)
    pix = order[r.clamp(0, order.shape[0] - 1)]
    pool = _issue(cfg, camera, pool, pix, pix_offset + pix,
                  base_counts[pix] + s_safe, have_work, base_seed)
    return pool, next_work + have_work.sum()


def _claim(cfg, work: PoolWork, pool: WavefrontPool, ctl: torch.Tensor):
    """The regeneration of a sweep: dead slots claim the next work items
    of ``work`` from the counters in ``ctl``. Returns (pool, next item,
    next_pix)."""
    if work.cum is None:
        return _regen(cfg, work.camera, pool, ctl[NEXT], ctl[NEXT_PIX],
                      work.spp, work.base_seed, work.it0, work.pix_offset,
                      work.n_valid)
    pool, nxt = _regen_budget(cfg, work.camera, pool, ctl[NEXT],
                              work.base_seed, work.base_counts, work.order,
                              work.cum, work.cum[-1], work.pix_offset)
    return pool, nxt, ctl[NEXT_PIX]


def _step(fs, cfg, work: PoolWork, pool: WavefrontPool, rgb: torch.Tensor,
          ns: torch.Tensor, ctl: torch.Tensor, tri: TriMode = EXACT):
    """One sweep of the pool loop, whole: the plain version of the sweep
    kernel. If the loop test ``ctl[GO]`` holds: ``_claim``, ``_sweep``
    (``tri``: the nearest hit's triangle test), the splat of the slots
    whose paths ended into rgb_sum (P, 3) and n_samples (P,), then the
    control words: the counters, one more sweep, the segments, and the
    test of the next sweep, (work pending or a slot active) and sweeps <
    cfg.wf_max_sweeps. Else everything stays as it is. A dead slot that
    claims no work keeps its planes. The splat adds into ``rgb`` and ``ns``
    in place. Returns (pool, rgb_sum, n_samples, ctl); the kernel updates
    all of its arguments in place and returns them."""
    go = ctl[GO] != 0
    claimed, nxt, nxt_pix = _claim(cfg, work, pool, ctl)
    swept, term, rays = _sweep(fs, cfg, claimed, tri)
    # _sweep counts a bounce for every slot, as tpurt's sweep does
    bounce = torch.where(claimed.active, swept.pi[BOUNCE],
                         claimed.pi[BOUNCE])
    swept = WavefrontPool(
        pf=swept.pf, rng=swept.rng,
        pi=torch.stack([swept.pi[PIX], bounce, swept.pi[ACTIVE]]))
    pix = swept.pi[PIX].long()
    ended = term & go
    splat = clamp_sample(cfg, swept.pf[RAD:RAD + 3].unbind(0))
    rgb.index_add_(0, pix, torch.where(ended[:, None],
                                       torch.stack(splat, 1), 0.0))
    ns.index_add_(0, pix, ended.to(torch.float32))
    sweeps = ctl[SWEEPS] + 1
    ctl_new = ctl.clone()
    ctl_new[SWEEPS] = sweeps
    ctl_new[NEXT] = nxt
    ctl_new[NEXT_PIX] = nxt_pix
    ctl_new[GO] = ((work.pending(nxt) | swept.active.any())
                   & (sweeps < cfg.wf_max_sweeps))
    ctl_new[RAYS] = ctl[RAYS] + rays
    keep = lambda new, old: torch.where(go, new, old)  # noqa: E731
    return (WavefrontPool(pf=keep(swept.pf, pool.pf),
                          pi=keep(swept.pi, pool.pi),
                          rng=keep(swept.rng, pool.rng)),
            rgb, ns, keep(ctl_new, ctl))


class PoolStep(NamedTuple):
    """What a step hook gives ``_drain``: ``sweep``, one sweep, ``(pool,
    rgb_sum, n_samples, ctl) -> the same`` as ``_step``; ``batch``, the
    sweeps enqueued per read of the loop test."""
    sweep: Callable
    batch: int


def plain_stepper(fs, cfg, work: PoolWork, tri: TriMode = EXACT,
                  batch: int = 1) -> PoolStep:
    """The step hook of the plain pool, (fs, cfg, work) -> ``_step``, one
    read of the loop test per ``batch`` sweeps."""
    return PoolStep(functools.partial(_step, fs, cfg, work, tri=tri), batch)


def xla_stepper(cfg):
    """The step hook of tpurt's XLA pool (backend "wavefront", and "xla"
    under ``render_adaptive``): ``plain_stepper``, through the per-ray walk
    of the Scene's BVH under ``use_bvh``."""
    if cfg.use_bvh:
        return functools.partial(plain_stepper, tri=BVH)
    return plain_stepper


def _pool_live(ctl: torch.Tensor) -> bool:
    """The loop test of the next sweep: the one read of the device per
    batch of sweeps."""
    return bool(ctl[GO])


def _drain(fs, cfg, state, work: PoolWork, step):
    """The sweep loop shared by the uniform and the budget renderers, over
    a pool of cfg.wf_pool slots: the hook ``step(fs, cfg, work)`` gives one
    sweep (``plain_stepper`` or the sweep kernel's ``stepper``) and the
    sweeps enqueued per read of the loop test. Returns (rgb_sum, n_samples,
    control words): the segments traced are ctl[RAYS], the sweeps taken
    ctl[SWEEPS]."""
    sweep, batch = step(fs, cfg, work)
    dev = state.device
    pool = new_pool(cfg.wf_pool, dev)
    rgb = state.rgb_sum.clone(memory_format=torch.contiguous_format)
    ns = state.n_samples.clone()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    ctl = new_ctl(cfg.wf_pool, work.pending(zero) & (cfg.wf_max_sweeps > 0),
                  dev)
    while True:
        for _ in range(batch):
            pool, rgb, ns, ctl = sweep(pool, rgb, ns, ctl)
        if not _pool_live(ctl):
            break
    return rgb, ns, ctl


def _check_state(state, scene) -> None:
    if scene.device != state.device:
        raise ValueError(f"scene on {scene.device}, state on {state.device}: "
                         f"move one with .to(device)")


def wavefront_render_slab(scene, cfg, camera, state, base_seed, spp: int,
                          pix_offset: int, n_valid: int, step=None):
    """``wavefront_render`` over one pixel slab: ``state`` holds the slab's
    rows, pixel ids are slab-local, RNG and camera use the global pixel
    ``pix_offset + row``. ``step`` is the step hook, ``plain_stepper`` by
    default; the sweep kernel's ``stepper`` takes its place for
    ``backend="wavefront_pallas"``."""
    check_sampler(cfg)
    check_slice(cfg)
    check_camera(cfg, camera)
    _check_state(state, scene)
    fs = freeze_scene(scene)
    spp = int(spp)
    work = PoolWork(camera=camera, base_seed=int(base_seed),
                    pix_offset=int(pix_offset), spp=spp, it0=state.iteration,
                    n_valid=int(n_valid))
    rgb, ns, ctl = _drain(fs, cfg, state, work,
                          plain_stepper if step is None else step)
    return dataclasses.replace(
        state, rgb_sum=rgb, n_samples=ns, iteration=state.iteration + spp,
        rays=state.rays + ctl[RAYS] if cfg.count_rays else state.rays)


def wavefront_render(scene, cfg, camera, state, base_seed, spp: int,
                     step=None):
    """Render ``spp`` samples per pixel through the persistent pool into
    the same RenderState as every backend (vispoints and photon radius
    untouched; ``iteration`` grows by ``spp``). ``step`` as in
    ``wavefront_render_slab``."""
    return wavefront_render_slab(scene, cfg, camera, state, base_seed, spp,
                                 0, cfg.n_pixels, step)
