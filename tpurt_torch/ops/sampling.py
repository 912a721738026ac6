"""Many-light next-event estimation: one light chosen per lane in
proportion to a power heuristic (``tpurt/ops/sampling.py``, the
``light_sample`` modes "power" and "spatial").

The selection is a fixed float32 chain in tpurt's order, so that the plain
integrator, tpurt and the CUDA kernels (``csrc/path.cuh nee_select``) pick
the same light on every lane: each power floored at 1e-20, a running total
over the lights in order, ``r = u_sel * total``, the first bucket whose
running total exceeds r (the last bucket open-ended, so that u_sel within
an ulp of 1 still selects a light), and ``1/pmf = total / p`` as one
float32 division.
"""

from __future__ import annotations

import numpy as np
import torch

from tpurt_torch.ops import fdiv

POWER_FLOOR = float(np.float32(1e-20))


def light_powers(intensities, hws, is_areas) -> list:
    """Per-light selection weights of mode "power": intensity * (4 hw^2
    for an area light, 1 for a point), emitted flux up to the wavelength's
    colour factor. Float32 scalars in, float32 scalars out, in tpurt's op
    order (``4 * hw``, times hw, times the intensity)."""
    out = []
    for inten, hw, area in zip(intensities, hws, is_areas):
        area_w = np.float32(4.0) * np.float32(hw) * np.float32(hw)
        out.append(np.float32(inten) * (area_w if area
                                        else np.float32(1.0)))
    return out


def light_power(lt) -> np.float32:
    """``light_powers`` of one frozen light (``scene.FLight``)."""
    return light_powers([lt.intensity], [lt.hw], [lt.ltype == 1])[0]


def _plane(p, like: torch.Tensor) -> torch.Tensor:
    p = p if isinstance(p, torch.Tensor) else torch.full_like(like, float(p))
    return p.clamp_min(POWER_FLOOR)


def select_light(u_sel: torch.Tensor, power_of, n: int):
    """The light each lane selects, in two passes over the n lights as the
    kernels make them: the running total, then the first bucket whose
    running total exceeds ``u_sel * total`` (the last bucket takes the
    rest). ``power_of(i)``: light i's weight, a float32 scalar or one per
    lane, computed again in the second pass. Returns (index int64 plane,
    1/pmf float32 plane)."""
    tot = None
    for i in range(n):
        p = _plane(power_of(i), u_sel)
        tot = p if tot is None else tot + p
    r = u_sel * tot
    idx = torch.full(u_sel.shape, n - 1, dtype=torch.int64,
                     device=u_sel.device)
    p_sel = _plane(power_of(n - 1), u_sel)
    found = torch.zeros_like(u_sel, dtype=torch.bool)
    cdf = None
    for i in range(n - 1):
        p = _plane(power_of(i), u_sel)
        cdf = p if cdf is None else cdf + p
        hit = ~found & (r < cdf)
        idx = torch.where(hit, i, idx)
        p_sel = torch.where(hit, p, p_sel)
        found = found | hit
    return idx, fdiv(tot, p_sel)


def select_from_powers(u_sel: torch.Tensor, powers):
    """tpurt's ``select_from_powers``: ``powers`` a sequence of float32
    scalars or per-lane planes. Returns (sels, inv_pmf): one boolean plane
    per light, exactly one true per lane, and the selected light's 1/pmf."""
    idx, inv_pmf = select_light(u_sel, lambda i: powers[i], len(powers))
    return [idx == i for i in range(len(powers))], inv_pmf


def light_select_power(u_sel: torch.Tensor, intensities, hws, is_areas):
    """Mode "power"'s selection: ``light_powers``, then
    ``select_from_powers``."""
    return select_from_powers(u_sel, light_powers(intensities, hws,
                                                  is_areas))


def select_chain(sels, values) -> torch.Tensor:
    """Per-lane gather by chained selects: values[i] where sels[i] (exactly
    one true per lane). values: (N,) or (N, 3) planes, or scalars or
    (1, 3) rows, which broadcast."""
    out = None
    for m, v in zip(sels, values):
        v = torch.as_tensor(v, dtype=torch.float32, device=m.device)
        mm = m[..., None] if v.dim() > m.dim() else m
        out = torch.where(mm, v, 0.0) if out is None \
            else torch.where(mm, v, out)
    return out
