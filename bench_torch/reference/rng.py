"""PCG (RXS-M-XS 32/32) streams and the photon and bounce strata of the
plain reference, copied from the port's ``tpurt_torch/ops/rng.py``.

A uint32 value is held in an int64 tensor in [0, 2**32): PyTorch on the CPU
has no uint32 ``+`` or ``>>``, so every ``+`` and ``*`` is followed by
``& MASK``. Products stay below 2**63 (a uint32 times a constant < 2**30).
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.reference import fmath

MASK = 0xFFFFFFFF
# f32(1 / 2**32): the reference divides by f32(0xFFFFFFFF) = 2**32 exactly
_INV_U32 = float(np.float32(1.0 / 4294967296.0))

_MUL = 747796405
_INC = 2891336453
_XSH_MUL = 277803737
_PHOTON_OFFSET = 0x9E3779B9
_PHOTON_K_STEP = 0x85EBCA6B
_WEYL = 2654435761


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return torch.tensor(int(x) & MASK, dtype=torch.int64)


def seed_pixels(seed, x, y):
    """Per-pixel stream: seed + 1203793*x + 7*y (mod 2**32)."""
    return (_u32(seed) + 1203793 * _u32(x) + 7 * _u32(y)) & MASK


def photon_stream(seed, x, y, k=0):
    """Stream of photon walk k; ``k`` is a Python int or an integer
    tensor (both give the same streams)."""
    off = (_PHOTON_OFFSET + _u32(k) * _PHOTON_K_STEP) & MASK
    return seed_pixels((_u32(seed) + off) & MASK, x, y)


def rand_u32(state):
    """One PCG step: (output hashed from the old state, new state)."""
    old = _u32(state)
    shift = (old >> 28) + 4
    res = (((old >> shift) ^ old) * _XSH_MUL) & MASK
    out = (res >> 22) ^ res
    new_state = (old * _MUL + _INC) & MASK
    return out, new_state


def u32_to_f32(bits):
    """One rounding of the 32-bit integer to float32 (int64 -> f32 cast)."""
    return bits.to(fmath.F)


def rand_1f(state):
    """Uniform in [0, 1], one float32 rounding of the draw."""
    bits, state = rand_u32(state)
    return u32_to_f32(bits) * _INV_U32, state


def frame_seed(base_seed: int, iteration):
    """Per-sample seed: the PCG hash of base + Weyl(iteration)
    (``tpurt.render._frame_seed``). A host int for an int ``iteration``;
    for an integer tensor of iterations (one per pool slot), a tensor of
    seeds on its device."""
    if isinstance(iteration, torch.Tensor):
        it = _u32(iteration)
        # Weyl * it mod 2**32 in 16-bit halves: a full product passes 2**63
        weyl_it = (_WEYL * (it & 0xFFFF)
                   + (((_WEYL * (it >> 16)) & 0xFFFF) << 16)) & MASK
        return rand_u32((int(base_seed) + weyl_it) & MASK)[0]
    x = (int(base_seed) + _WEYL * int(iteration)) & MASK
    out, _ = rand_u32(torch.tensor(x, dtype=torch.int64))
    return int(out)


# ----- tile-coherent strata (tpurt.ops.rng: photon_strata and friends) -----
# A stratum cell is a pure function of the frame (or strata-epoch) seed, the
# photon index k and the bounce: every pixel of a sample shares it. ``seed``,
# ``k`` and ``bounce`` are Python ints or integer tensors (one per pixel in
# the budget renderer), as in ``photon_stream``.

_STRATA_OFFSET = 0xA511E9B3
_STRATA_K_STEP = 0x632BE5AB
_BOUNCE_OFFSET = 0x7F4A7C15
_BOUNCE_STEP = 0x94D049BB
# the camera path's bounce-cell key, disjoint from every photon k
CAMERA_STRATA_K = 0x5BD1
# largest float32 below 1: remapped uniforms stay inside [0, 1)
_BELOW_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def _check_strata(n: int, what: str, wide: bool = False) -> None:
    """A power of two up to 256 (four 8-bit fields of one hash word), or up
    to 4096 for direction cells (``wide``: two 16-bit fields of a second
    word; finer cells would quantize the uniform inside a cell)."""
    cap = 4096 if wide else 256
    if not (0 < n <= cap and (n & (n - 1)) == 0):
        raise ValueError(
            f"{what} must be a power of two in [1, {cap}], got {n}")


def emission_strata(seed, k, n_pos: int, n_dir: int):
    """The four stratum indices (pos_u, pos_v in [0, n_pos); dir_a, dir_b
    in [0, n_dir)) of photon k of the sample with this seed, as float32."""
    _check_strata(n_pos, "photon_strata")
    _check_strata(n_dir, "photon_strata_dir", wide=True)
    off = (_STRATA_OFFSET + _u32(k) * _STRATA_K_STEP) & MASK
    h, s2 = rand_u32((_u32(seed) + off) & MASK)
    mp, md = n_pos - 1, n_dir - 1
    if n_dir <= 256:
        da, db = (h >> 16) & md, (h >> 24) & md
    else:
        h2, _ = rand_u32(s2)
        da, db = h2 & md, (h2 >> 16) & md
    return tuple(i.to(fmath.F)
                 for i in (h & mp, (h >> 8) & mp, da, db))


def strata_counts(cfg) -> tuple[int, int]:
    """(n_pos, n_dir); photon_strata_dir 0 means photon_strata."""
    n_pos = int(cfg.photon_strata)
    return n_pos, int(cfg.photon_strata_dir) or n_pos


def strata_k(cfg, k):
    """The photon index the stratum hash sees: 0 for every k under
    photon_strata_shared_k."""
    return 0 if cfg.photon_strata_shared_k else k


def _remap(u, s, inv: float):
    return torch.clamp_max((s + u) * inv, _BELOW_ONE)


def apply_emission_strata(seed, k, n_pos: int, n_dir: int,
                          uc, up1, ue1, ue2, uh1, uh2):
    """The six emission uniforms moved into their (sample, k) cell: the
    cone polar uc and hemisphere angle uh1 share dir_a, the cone azimuth
    up1 and hemisphere radius uh2 share dir_b, the quad position (ue1, ue2)
    takes (pos_u, pos_v)."""
    pu, pv, da, db = emission_strata(seed, k, n_pos, n_dir)
    inv_p = float(np.float32(1.0 / n_pos))
    inv_d = float(np.float32(1.0 / n_dir))
    return (_remap(uc, da, inv_d), _remap(up1, db, inv_d),
            _remap(ue1, pu, inv_p), _remap(ue2, pv, inv_p),
            _remap(uh1, da, inv_d), _remap(uh2, db, inv_d))


def apply_bounce_strata(seed, k, bounce, n_dir: int, ua, ub, uch):
    """A bounce's scatter uniforms (the u2 pair and the reflect/refract
    choice) moved into the (sample, k, bounce) cell; the roulette uniform
    is never remapped."""
    _check_strata(n_dir, "photon_strata bounce cells", wide=True)
    s0 = (_u32(seed) + _BOUNCE_OFFSET + _u32(k) * _STRATA_K_STEP
          + _u32(bounce) * _BOUNCE_STEP) & MASK
    h, s1 = rand_u32(s0)
    md = n_dir - 1
    if n_dir <= 256:
        a, b, c = h & md, (h >> 8) & md, (h >> 16) & md
    else:
        h2, _ = rand_u32(s1)
        a, b, c = h & md, (h >> 16) & md, h2 & md
    inv = float(np.float32(1.0 / n_dir))
    return tuple(_remap(u, i.to(fmath.F), inv)
                 for u, i in ((ua, a), (ub, b), (uch, c)))
