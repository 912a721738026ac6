"""Variance-adaptive sampling (``tpurt/adaptive.py``): the wavefront pool's
budget renderer, and ``render_adaptive`` over every backend.

``wavefront_render_budget`` renders ``budgets[p]`` further samples for
every pixel p, enumerating work round-major: one sample per still-hungry
pixel per round, pixels in stable descending-budget order. Pixel p's k-th
sample draws the same PCG stream as on every other backend (iteration
n_samples[p] + k), so with a uniform budget the enumeration, the pool
schedule and the float adds are those of ``wavefront_render``: the states
are equal to the bit. It is also the plain version of the fused kernel's
budget mode (``kernels/wavefront_fused.py``).

``render_adaptive`` runs adaptive sampling end to end: two half-pilot
passes, a per-pixel noise proxy from their disagreement, then one budget
pass that spends the remaining samples where the image is still noisy;
on ``backend="pallas"`` that pass is the regen kernel's budget mode
(``kernels/mega_regen.py``), photons included.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpurt_torch import wavefront
from tpurt_torch.camera import check_camera
from tpurt_torch.config import check_slice
from tpurt_torch.ops import fdiv
from tpurt_torch.scene import freeze_scene
from tpurt_torch.tonemap import LUMA


def _round_major_tables(budgets: torch.Tensor, max_budget: int):
    """Tables of the round-major enumeration. Work item w maps to round
    s = the first index with cum[s] > w, and to pixel order[w - cum[s-1]]:
    c[s] = #pixels with budget > s, cum = cumsum(c), ``order`` the pixels
    in stable descending-budget order. Returns (order, cum, total), int64
    tensors on the budgets' device."""
    p = budgets.shape[0]
    counts = torch.bincount(budgets.long(), minlength=max_budget + 1)
    le = torch.cumsum(counts, 0)                 # #pixels with budget <= s
    c = p - le[:max_budget]                      # #pixels with budget >  s
    cum = torch.cumsum(c, 0)
    order = torch.argsort(-budgets.long(), stable=True)
    return order, cum, cum[max_budget - 1]


def clip_budgets(cfg, budgets: torch.Tensor, max_budget: int
                 ) -> torch.Tensor:
    """Budgets as the fused kernel takes them (``tpurt``'s
    ``_fused_budget_jit``): int64, clipped to [0, max_budget], 0 on the pad
    rows past the image."""
    b = budgets.long().clamp(0, int(max_budget))
    rows = torch.arange(b.shape[0], device=b.device)
    return torch.where(rows < cfg.n_pixels, b, 0)


def wavefront_render_budget_slab(scene, cfg, camera, state, base_seed,
                                 budgets, max_budget: int, pix_offset: int,
                                 step=None):
    """``wavefront_render_budget`` over one pixel slab: ``state`` and
    ``budgets`` hold the slab's rows, RNG and camera coordinates add
    ``pix_offset``. ``step`` as in ``wavefront.wavefront_render_slab``."""
    wavefront.check_sampler(cfg)
    check_slice(cfg)
    check_camera(cfg, camera)
    wavefront._check_state(state, scene)
    if max_budget < 1:
        raise ValueError(f"max_budget must be >= 1, got {max_budget}")
    if budgets.shape != state.n_samples.shape:
        raise ValueError(f"budgets {tuple(budgets.shape)} do not match the "
                         f"state's {tuple(state.n_samples.shape)} rows")
    fs = freeze_scene(scene)
    budgets = budgets.to(state.device).long().clamp(0, int(max_budget))
    order, cum, _ = _round_major_tables(budgets, int(max_budget))
    work = wavefront.PoolWork(camera=camera, base_seed=int(base_seed),
                              pix_offset=int(pix_offset), order=order,
                              cum=cum, base_counts=state.n_samples.long())
    rgb, ns, ctl = wavefront._drain(
        fs, cfg, state, work,
        wavefront.plain_stepper if step is None else step)
    return dataclasses.replace(
        state, rgb_sum=rgb, n_samples=ns,
        iteration=state.iteration + int(max_budget),
        rays=(state.rays + ctl[wavefront.RAYS] if cfg.count_rays
              else state.rays))


def wavefront_render_budget(scene, cfg, camera, state, base_seed, budgets,
                            max_budget: int, step=None):
    """Render ``budgets[p]`` more samples for every pixel p (budgets: one
    integer per state row, pad rows 0, clipped to [0, max_budget]). Camera
    paths only, like the uniform wavefront; ``iteration`` grows by
    ``max_budget``."""
    return wavefront_render_budget_slab(scene, cfg, camera, state, base_seed,
                                        budgets, max_budget, 0, step)


def _box3(img: torch.Tensor) -> torch.Tensor:
    """3x3 box filter with edge replication on an (H, W) map. The nine
    taps are summed in tpurt's order and scaled by float32(1/9): under jit
    XLA turns tpurt's division by the constant 9 into that product."""
    p = torch.nn.functional.pad(img[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    acc = torch.zeros_like(img)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            acc = acc + p[dy:dy + img.shape[0], dx:dx + img.shape[1]]
    return acc * float(np.float32(1.0 / 9.0))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add. The
    product of two float32 is exact in float64; the float64 sum is rounded
    to odd (its error from Knuth's two-sum), so that rounding it to float32
    equals rounding the exact sum."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    nudged = torch.nextafter(s, torch.where(err > 0, inf, -inf))
    return torch.where((err != 0) & even, nudged, s).float()


def luma_gap(sum_a, n_a, sum_b, n_b) -> torch.Tensor:
    """|luma(mean_a) - luma(mean_b)| per state row. The luma is summed in
    tpurt's order: XLA's CPU dot forms ``(mean_a - mean_b) @ luma`` as a
    chain of fused multiply-adds over ascending channels."""
    diff = (fdiv(sum_a, n_a.clamp_min(1.0)[:, None])
            - fdiv(sum_b, n_b.clamp_min(1.0)[:, None]))
    luma = torch.tensor(LUMA, dtype=torch.float32, device=sum_a.device)
    acc = diff[:, 0] * luma[0]
    for c in (1, 2):
        acc = _fma(diff[:, c], luma[c].expand_as(acc), acc)
    return acc.abs()


def variance_proxy(cfg, sum_a, n_a, sum_b, n_b, smooth: bool = True):
    """Per-pixel noise proxy from two independent half-estimates:
    |luma(mean_a) - luma(mean_b)| (``luma_gap``), box-smoothed, plus a
    floor of 5% of its mean so every pixel keeps a nonzero chance. A
    (rows,) float32 map, pad rows 0. The floor's mean is a float32 sum in
    PyTorch's order, not XLA's, so the map can differ from tpurt's by an
    ulp of the floor."""
    d = luma_gap(sum_a, n_a, sum_b, n_b)
    n = cfg.n_pixels
    img = d[:n].reshape(cfg.height, cfg.width)
    if smooth:
        img = _box3(img)
    img = img + (0.05 * img.mean() + 1e-12)
    out = torch.zeros((sum_a.shape[0],), dtype=torch.float32,
                      device=sum_a.device)
    out[:n] = img.reshape(-1)
    return out


def allocate_budgets(proxy: torch.Tensor, total: int, max_budget: int,
                     power: float = 0.5) -> torch.Tensor:
    """Spend ``total`` samples across pixels in proportion to
    ``proxy ** power``, rounded (half to even) and clipped to
    [0, max_budget]; pad rows (proxy 0) get 0. int32."""
    p = torch.where(proxy > 0, proxy, 0.0) ** power
    p = p / p.sum().clamp_min(1e-30)
    alloc = torch.round(p * float(total)).to(torch.int32)
    return alloc.clamp(0, max_budget)


def render_adaptive(scene, cfg, camera, base_seed=0, spp: int = 64,
                    pilot_spp: int = 8, budget_cap: int = 16,
                    smooth: bool = True, alloc_power: float = 0.5):
    """Adaptive render at a mean of ``spp`` samples per pixel: two uniform
    pilots of pilot_spp/2 each, then the remaining (spp - pilot_spp) *
    n_pixels samples spent in proportion to proxy**alloc_power (per-pixel
    cap budget_cap * (spp - pilot_spp)). The state lives on the scene's
    device. Returns (state, budgets).

    ``backend="pallas"`` runs the pilots through ``render`` (the regen
    kernel) and the rest through the regen kernel's budget mode
    (``kernels.mega_regen.render_budget_regen``): the full estimator,
    photons included. ``"wavefront_fused"`` runs both phases through the
    fused kernel's wrappers, ``"wavefront_pallas"`` through the pool with
    the sweep kernel, any other wavefront or ``"xla"`` backend through the
    plain pool (camera paths only), as tpurt routes them."""
    from tpurt_torch.render import init_state
    if pilot_spp < 2 or pilot_spp % 2:
        raise ValueError("pilot_spp must be an even count >= 2")
    if spp < pilot_spp:
        raise ValueError("spp must be >= pilot_spp")
    h = pilot_spp // 2
    remaining = (spp - pilot_spp) * cfg.n_pixels
    max_budget = max(1, (spp - pilot_spp) * budget_cap)
    if cfg.n_pixels * max_budget >= 2 ** 31:
        raise ValueError("summed budget bound overflows int32: lower "
                         "budget_cap or split into several calls")
    if cfg.backend == "pallas":
        if not cfg.pallas_regen:
            raise ValueError("adaptive sampling on backend='pallas' needs "
                             "the regenerative kernel (pallas_regen=True)")
        from tpurt_torch.kernels import mega_regen
        from tpurt_torch.render import render
        uniform_fn, budget_fn = render, mega_regen.render_budget_regen
    elif cfg.backend == "wavefront_fused":
        from tpurt_torch.kernels import wavefront_fused as wf
        uniform_fn = wf.wavefront_render_fused
        budget_fn = wf.wavefront_render_budget_fused
    elif cfg.backend == "wavefront_pallas":
        from tpurt_torch.kernels import wavefront_sweep as ws
        uniform_fn = ws.wavefront_render_pallas
        budget_fn = functools.partial(wavefront_render_budget,
                                      step=ws.stepper)
    else:
        step = wavefront.xla_stepper(cfg)
        uniform_fn = functools.partial(wavefront.wavefront_render, step=step)
        budget_fn = functools.partial(wavefront_render_budget, step=step)

    state = init_state(cfg, scene.device)
    state = uniform_fn(scene, cfg, camera, state, base_seed, h)
    # contiguous: a view of the render's planes would keep all 16 rows
    sum_a, n_a = state.rgb_sum.contiguous(), state.n_samples
    state = uniform_fn(scene, cfg, camera, state, base_seed, h)
    sum_b = state.rgb_sum - sum_a
    n_b = state.n_samples - n_a

    proxy = variance_proxy(cfg, sum_a, n_a, sum_b, n_b, smooth)
    budgets = allocate_budgets(proxy, remaining, max_budget, alloc_power)
    if remaining > 0:
        state = budget_fn(scene, cfg, camera, state, base_seed, budgets,
                          max_budget)
    return state, budgets
