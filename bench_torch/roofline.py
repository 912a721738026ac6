"""The least time an H100 could take for a path kernel's work, and the
published peaks it is stated against (the arithmetic of the port's
``chip_smoke.py``, copied so that the yardstick stays with the benchmark).

The bound is the larger of the bytes a call must move over 3.35 TB/s and
its float32 operations over 67 TFLOP/s (H100 SXM data sheet, float32
outside the tensor cores, at the full 700 W power limit). A path kernel's
work depends on the data: it is counted as segments x OPS_PER_SEGMENT, a
floor read off the kernels' device code: the nearest-hit test of one sphere
is 17 operations before its root (oc 3, half_b 5, c 6, disc 3) and ~6 after,
a Cornell segment tests 8 spheres (~180), and the shading behind it (4
draws and the scatter with roulette, or a shadow test of 8 spheres with its
Fresnel terms, or the density estimate with the gather BSDF) is over 120
more. A mesh segment costs more than this floor, so its bound is looser.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
OPS_PER_SEGMENT = 300
OPS_PER_BLIT_PIXEL = 30   # 3 divides, luma, Reinhard, saturation lerp


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms and bound_by of a call moving nbytes and doing ops."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def path_bound(pixels: int, segments: int) -> dict:
    """A path kernel launch's bound: the (16, P) float32 planes read and
    written once, and OPS_PER_SEGMENT per traced segment."""
    return bound(16 * 4 * 2 * pixels, segments * OPS_PER_SEGMENT)
