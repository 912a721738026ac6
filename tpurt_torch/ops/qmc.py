"""Owen-scrambled Sobol draws for the camera spawn (``cfg.qmc``), bit-exact
with ``tpurt.ops.qmc``.

With ``RenderConfig.qmc=True`` the camera-spawn uniforms (pixel jitter,
shutter time, lens disc, wavelength, in that order) come from a per-pixel
Owen-scrambled Sobol sequence indexed by the global sample number; every
later draw (path scatter, NEE, photons, roulette) keeps its PCG stream,
which then starts at position 0 instead of after the spawn draws. Sample i
of a pixel is a pure function of (base seed, pixel, i, dimension), so every
backend draws the same spawn whatever its schedule.

Sobol points in 6 dimensions (dimension 0 the van der Corput sequence,
1-5 from the Joe-Kuo direction numbers), evaluated by XOR-folding direction
numbers over the index bits; each (pixel, dimension) scrambles them with
the Laine-Karras hash (Burley, "Practical Hash-based Owen Scrambling",
JCGT 2020). uint32 values are held in int64 tensors masked to 32 bits, as
in ``ops.rng``. The kernels read the same direction table
(``DIRECTIONS``), which their wrappers pass with the launch.

``QmcStream`` is accepted by ``ops.rng.rand_1f``/``rand_2f`` in place of
the PCG state: each draw consumes the next dimension, and a draw past
``N_DIMS`` raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpurt_torch.ops import rng as rngmod
from tpurt_torch.ops.rng import MASK

# (s, a, m[1..s]) per Joe-Kuo ("new-joe-kuo-6"): degree, coefficient bits,
# initial direction integers of dimensions 1-5
_JOE_KUO = (
    (1, 0, (1,)),
    (2, 1, (1, 3)),
    (3, 1, (1, 3, 1)),
    (3, 2, (1, 1, 1)),
    (4, 1, (1, 1, 3, 3)),
)

N_DIMS = 1 + len(_JOE_KUO)  # jitter x/y, time, lens u/v, wavelength


def _direction_table() -> np.ndarray:
    """(N_DIMS, 32) uint32 direction numbers v_k, MSB-aligned."""
    dims = [[1 << (31 - k) for k in range(32)]]
    for s, a, m_init in _JOE_KUO:
        m = list(m_init)
        for k in range(s, 32):
            x = m[k - s] ^ (m[k - s] << s)
            for j in range(1, s):
                if (a >> (s - 1 - j)) & 1:
                    x ^= m[k - j] << j
            m.append(x)
        dims.append([m[k] << (31 - k) for k in range(32)])
    return (np.asarray(dims, np.uint64) & MASK).astype(np.uint32)


DIRECTIONS = _direction_table()

_QMC_SALT = 0x5173B0C1   # decouples the scramble-seed hash
_DIM_STEP = 0x9E3779B9   # from every PCG stream family


def sobol_u32(idx, dim: int):
    """Sobol point ``idx`` of dimension ``dim`` as uint32 bits (the MSB is
    the first binary digit of the fraction)."""
    idx = rngmod._u32(idx)
    acc = torch.zeros_like(idx)
    for b in range(32):
        acc = acc ^ (((idx >> b) & 1) * int(DIRECTIONS[dim, b]))
    return acc


def reverse_bits_u32(x):
    """Bit reversal of a uint32 (5 SWAR steps)."""
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & MASK


def _mul(x, c: int):
    """x * c mod 2**32 for a uint32 x and constant c, in 16-bit halves of
    c: a full product passes 2**63."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK


def _laine_karras(x, seed):
    """The Laine-Karras permutation: every output bit depends only on its
    own and lower input bits; each step is a bijection."""
    x = (x + seed) & MASK
    x = x ^ _mul(x, 0x6C50B47C)
    x = x ^ _mul(x, 0xB82F1E52)
    x = x ^ _mul(x, 0xC7AFE638)
    x = x ^ _mul(x, 0x8D22F6E6)
    return x


def owen_scramble_u32(bits, seed):
    """Owen-scrambled Sobol fraction bits for a per-(pixel, dim) seed."""
    x = reverse_bits_u32(rngmod._u32(bits))
    x = _laine_karras(x, rngmod._u32(seed))
    return reverse_bits_u32(x)


@dataclasses.dataclass(frozen=True)
class QmcStream:
    """The spawn draws of a lane: ``idx`` its global sample index, ``pix``
    its per-pixel scramble base, ``dim`` the next dimension (the same at
    each draw site of every backend)."""
    idx: torch.Tensor
    pix: torch.Tensor
    dim: int = 0

    def next_1f(self):
        d = self.dim
        if d >= N_DIMS:
            raise ValueError(
                f"QMC spawn stream exhausted ({N_DIMS} dims): the spawn "
                "draws more uniforms than qmc.N_DIMS")
        bits = sobol_u32(self.idx, d)
        sd, _ = rngmod.rand_u32((self.pix + ((d * _DIM_STEP) & MASK)) & MASK)
        bits = owen_scramble_u32(bits, sd)
        u = rngmod.u32_to_f32(bits) * rngmod._INV_U32
        return u, QmcStream(self.idx, self.pix, d + 1)


def spawn_stream(base_seed, sample_index, px, py) -> QmcStream:
    """The QMC stream of one camera spawn: ``base_seed`` the render's base
    seed (never the frame seed), ``sample_index`` the global progressive
    sample number (an int, or one per lane), ``px``/``py`` the pixels."""
    salt = rngmod._u32(base_seed) ^ _QMC_SALT
    pix, _ = rngmod.rand_u32(rngmod.seed_pixels(salt, px, py))
    if not isinstance(sample_index, torch.Tensor):
        sample_index = torch.tensor(int(sample_index), dtype=torch.int64,
                                    device=pix.device)
    idx = rngmod._u32(sample_index.to(pix.device)).expand_as(pix)
    return QmcStream(idx=idx, pix=pix, dim=0)
