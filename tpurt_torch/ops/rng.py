"""PCG (RXS-M-XS 32/32) streams, bit-exact with ``tpurt.ops.rng``.

A uint32 value is held in an int64 tensor in [0, 2**32): PyTorch on the CPU
has no uint32 ``+`` or ``>>``, so every ``+`` and ``*`` is followed by
``& MASK``. Products stay below 2**63 (a uint32 times a constant < 2**30).
"""

from __future__ import annotations

import numpy as np
import torch

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
    return bits.to(torch.float32)


def rand_1f(state):
    """Uniform float32 in [0, 1]."""
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
