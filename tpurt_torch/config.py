"""Render configuration of the PyTorch port.

Field for field the same names and defaults as ``tpurt.config.RenderConfig``
(the meaning of every knob is documented there), so ``.npz`` checkpoints
carry a config that both packages load. The port implements a slice of
these knobs; ``check_slice`` names the first knob set outside it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1920
    height: int = 1080
    depth: int = 30
    rr_threshold: float = 0.001
    enable_photons: bool = True
    k_photons: int = 4
    max_photon_bounces: int = 8
    photon_radius_init: float = 2.0
    photon_rr_threshold: float = 0.01
    photon_rr_scale: float = 1.0
    photon_aim: float = 0.0
    photon_aim_widen: float = 3.0
    sppm_alpha: float = 0.67
    photon_strata: int = 0
    photon_strata_dir: int = 0
    photon_strata_shared_k: bool = False
    photon_strata_bounce: bool = False
    pallas_phase_split_votes: bool = False
    camera_strata_bounce: bool = False
    photon_strata_window: int = 1
    hero_wavelengths: int = 1
    dispersion_in_camera_path: bool = False
    aperture: float = 0.0
    focus_dist: float = 1.0
    light_sample: str = "all"
    qmc: bool = False
    motion_blur: bool = False
    use_bvh: bool = False
    backend: str = "xla"
    tile_size: int = 16384
    pallas_lanes: int = 4096
    pallas_regen: bool = True
    pallas_regen_drift: int = 0
    pallas_regen_drift_cam: int = 0
    pallas_static_unroll: int = 32
    pallas_block_tiles: bool = True
    pallas_cluster_size: int = 16
    pallas_cluster_ordered: bool = False
    sphere_chunk: int = 512
    tri_chunk: int = 256
    pallas_bvh: bool = True
    pallas_bvh_rows: int = 0
    pallas_bvh_leaf: int = 32
    pallas_bvh_width: int = 0
    pallas_bvh_sah: bool = False
    pallas_bvh_chunk: int = 2048
    pallas_chunk_prefetch: bool = False
    pallas_chunk_interleave: bool = False
    pallas_bvh_chunk_threshold: int = 0
    pallas_mxu_leaf: bool = False
    pallas_tri_clip: bool = True
    pallas_sphere_bvh: bool = False
    wf_pool: int = 262144
    wf_max_sweeps: int = 100000
    wf_chunk_sort: bool = False
    sky_gradient: bool = False
    sky_intensity: float = 0.0
    sky_color: tuple = (1.0, 1.0, 1.0)
    sky_temp: float = 0.0
    radiance_clamp: float = 0.0
    count_rays: bool = True
    count_iters: bool = False
    count_walk_stats: bool = False
    tonemap_key: float = 0.8
    tonemap_saturation: float = 1.0

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


# Knobs the slice implements, with any value.
_SLICE_FIELDS = frozenset({
    "width", "height", "depth",
    "k_photons", "max_photon_bounces", "enable_photons",
    "photon_radius_init", "sppm_alpha",
    "rr_threshold", "photon_rr_threshold",
    "count_rays", "tonemap_key", "tonemap_saturation",
    "backend", "pallas_regen", "tile_size", "pallas_lanes",
    "wf_pool", "wf_max_sweeps",
    "pallas_bvh", "pallas_bvh_leaf", "pallas_bvh_width", "pallas_bvh_sah",
    "pallas_sphere_bvh", "pallas_static_unroll",
})

# Knobs tpurt documents as scheduling-only (bit-identical results): the
# port accepts them and ignores them.
_SCHEDULING_FIELDS = frozenset({
    "pallas_block_tiles", "pallas_regen_drift", "pallas_regen_drift_cam",
    "pallas_cluster_size", "pallas_cluster_ordered", "pallas_tri_clip",
    "pallas_bvh_rows", "pallas_bvh_chunk", "pallas_chunk_prefetch",
    "pallas_chunk_interleave", "wf_chunk_sort", "pallas_bvh_chunk_threshold",
    "tri_chunk", "sphere_chunk",
})

_BACKENDS = ("xla", "pallas", "wavefront", "wavefront_pallas",
             "wavefront_fused")


def check_slice(cfg: RenderConfig) -> None:
    """Raise NotImplementedError naming the first knob outside the slice."""
    default = RenderConfig()
    for f in dataclasses.fields(RenderConfig):
        if f.name in _SLICE_FIELDS or f.name in _SCHEDULING_FIELDS:
            continue
        if getattr(cfg, f.name) != getattr(default, f.name):
            raise NotImplementedError(
                f"RenderConfig.{f.name}={getattr(cfg, f.name)!r} is not "
                f"ported to tpurt_torch yet (default "
                f"{getattr(default, f.name)!r})")
    if cfg.backend not in _BACKENDS:
        raise NotImplementedError(
            f"RenderConfig.backend={cfg.backend!r} is not ported to "
            f"tpurt_torch yet (ported: {_BACKENDS})")
    if cfg.backend == "pallas" and not cfg.pallas_regen:
        raise NotImplementedError(
            "RenderConfig.pallas_regen=False (the tile-synchronized "
            "megakernel) is not ported to tpurt_torch yet")
    if cfg.depth < 1 or cfg.max_photon_bounces < 1:
        raise ValueError("depth and max_photon_bounces must be >= 1")
    if cfg.backend.startswith("wavefront") and cfg.wf_pool < 1:
        raise ValueError(f"wf_pool must be >= 1, got {cfg.wf_pool}")
    if not 0 <= cfg.pallas_bvh_width <= 8:
        raise ValueError(f"pallas_bvh_width must be 0-2 (binary) or 3-8 "
                         f"(wide), got {cfg.pallas_bvh_width}")
