"""Render configuration of the PyTorch port.

Field for field the same names and defaults as ``tpurt.config.RenderConfig``
(the meaning of every knob is documented there), so ``.npz`` checkpoints
carry a config that both packages load. The port implements a slice of
these knobs; ``check_slice`` names the first knob set outside it.
"""

from __future__ import annotations

import dataclasses

from tpurt_torch.ops import rng as rngmod


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

    # tpurt's named flag stacks (tpurt.config.RenderConfig.PRESETS)
    PRESETS = {
        # every extension off (== RenderConfig())
        "reference": {},
        # hero wavelengths and the Owen-scrambled Sobol camera spawn
        "quality": dict(hero_wavelengths=4, qmc=True),
        # quality plus photon-walk roulette thinning
        "fast": dict(hero_wavelengths=4, qmc=True, photon_rr_scale=0.5),
        # the walk scenes' stack (meshes, many-sphere instancing): photon
        # emission and bounce strata, camera bounce strata, hero 4
        "walk": dict(photon_strata=16, photon_strata_dir=4096,
                     photon_strata_shared_k=True, photon_strata_bounce=True,
                     camera_strata_bounce=True, photon_strata_window=1,
                     pallas_regen_drift=1, hero_wavelengths=4),
    }

    @classmethod
    def preset(cls, name: str, **overrides) -> "RenderConfig":
        """The RenderConfig of a named flag stack, any field overridable:
        ``RenderConfig.preset("quality", width=1920, height=1080)``.
        Unknown names raise with the list."""
        if name not in cls.PRESETS:
            raise ValueError(f"unknown preset {name!r}; "
                             f"available: {sorted(cls.PRESETS)}")
        return cls(**{**cls.PRESETS[name], **overrides})

    @staticmethod
    def parse_overrides(pairs) -> dict:
        """CLI ``--set KEY=VAL`` pairs -> a kwargs dict: values through
        ast.literal_eval, a bare string where that fails
        (``backend=pallas``); an unknown field name exits with a
        message."""
        import ast
        fields = {f.name for f in dataclasses.fields(RenderConfig)}
        out = {}
        for kv in pairs or ():
            k, _, v = kv.partition("=")
            if k not in fields:
                raise SystemExit(
                    f"--set {k}: not a RenderConfig field "
                    f"(see tpurt_torch/config.py for the list)")
            try:
                out[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                out[k] = v
        return out

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
    # tpurt's sampler: on every backend, except that the wavefront tracers
    # trace no photons (photon strata change nothing there) and reject
    # camera strata (wavefront.check_sampler)
    "hero_wavelengths", "dispersion_in_camera_path",
    "photon_strata", "photon_strata_dir", "photon_strata_shared_k",
    "photon_strata_bounce", "photon_strata_window", "camera_strata_bounce",
    # triangle tests: tpurt's G-matrix leaf (the regen kernel, where
    # kernels/bvh.py mxu_leaf_engages holds) and the XLA per-ray walk
    # (backend="xla" and the plain "wavefront" pool)
    "pallas_mxu_leaf", "use_bvh",
    # emission on every backend: the sky on a camera miss (sky_gradient
    # alone is the wavefront tracers' legacy RGB ramp, ignored elsewhere,
    # as in tpurt) and the per-sample radiance clamp; emissive materials
    # (type 3) are a property of the scene
    "sky_gradient", "sky_intensity", "sky_color", "sky_temp",
    "radiance_clamp",
    # the camera-spawn extensions on every backend (the thin lens, the
    # shutter with a MotionCamera, the Sobol spawn draws) and the photon
    # walks' roulette thinning
    "aperture", "focus_dist", "motion_blur", "qmc", "photon_rr_scale",
    # many-light NEE on every backend; aimed photon emission where tpurt
    # has it (the XLA twin and the regen kernel, check_slice)
    "light_sample", "photon_aim", "photon_aim_widen",
})

# Knobs tpurt documents as scheduling-only (bit-identical results): the
# port accepts them and ignores them. pallas_bvh_chunk and
# pallas_bvh_chunk_threshold schedule nothing here (one walk serves every
# size), but they decide whether pallas_mxu_leaf engages: tpurt runs the G
# leaf on its single-table walk only (kernels/bvh.py mxu_leaf_engages).
_SCHEDULING_FIELDS = frozenset({
    "pallas_block_tiles", "pallas_regen_drift", "pallas_regen_drift_cam",
    "pallas_cluster_size", "pallas_cluster_ordered", "pallas_tri_clip",
    "pallas_bvh_rows", "pallas_bvh_chunk", "pallas_chunk_prefetch",
    "pallas_chunk_interleave", "wf_chunk_sort", "pallas_bvh_chunk_threshold",
    "tri_chunk", "sphere_chunk", "pallas_phase_split_votes",
})

_DEFAULT = RenderConfig()   # frozen: check_slice compares against it

_BACKENDS = ("xla", "pallas", "wavefront", "wavefront_pallas",
             "wavefront_fused")


def check_slice(cfg: RenderConfig) -> None:
    """Raise NotImplementedError naming the first knob outside the slice,
    and tpurt's errors for bad values (``tpurt.render._check_camera_kind``
    and the checks beside it), with its exception types and messages:
    photon_aim runs in the XLA twin and the regen kernel only, as in
    tpurt."""
    for f in dataclasses.fields(RenderConfig):
        if f.name in _SLICE_FIELDS or f.name in _SCHEDULING_FIELDS:
            continue
        if getattr(cfg, f.name) != getattr(_DEFAULT, f.name):
            raise NotImplementedError(
                f"RenderConfig.{f.name}={getattr(cfg, f.name)!r} is not "
                f"ported to tpurt_torch yet (default "
                f"{getattr(_DEFAULT, f.name)!r})")
    if cfg.backend not in _BACKENDS:
        raise NotImplementedError(
            f"RenderConfig.backend={cfg.backend!r} is not ported to "
            f"tpurt_torch yet (ported: {_BACKENDS})")
    if cfg.light_sample not in ("all", "power", "spatial"):
        raise ValueError(f"cfg.light_sample must be 'all', 'power' or "
                         f"'spatial', got {cfg.light_sample!r}")
    if not 0.0 <= cfg.photon_aim < 1.0:
        # q = 1 would drop the cosine component of the emission mixture
        raise ValueError(f"cfg.photon_aim must be in [0, 1), got "
                         f"{cfg.photon_aim!r}")
    if cfg.photon_aim > 0.0 and not cfg.photon_aim_widen > 0.0:
        raise ValueError(f"cfg.photon_aim_widen must be > 0 when "
                         f"photon_aim > 0, got {cfg.photon_aim_widen!r}")
    if cfg.photon_aim > 0.0 and (
            cfg.backend.startswith("wavefront")
            or (cfg.backend == "pallas" and not cfg.pallas_regen)):
        raise NotImplementedError(
            "cfg.photon_aim is implemented in the XLA integrator and the "
            "regenerative megakernel only — use backend='xla' or "
            "backend='pallas' (pallas_regen=True, the default)")
    if not 0.0 < cfg.photon_rr_scale <= 1.0:
        # above 1 the reweight would divide by more than the survival
        # probability, which u_rr < 1 caps: darker photons, not longer walks
        raise ValueError(f"cfg.photon_rr_scale must be in (0, 1], got "
                         f"{cfg.photon_rr_scale!r}")
    if cfg.hero_wavelengths < 1:
        raise ValueError(f"hero_wavelengths must be >= 1, got "
                         f"{cfg.hero_wavelengths}")
    if cfg.photon_strata:
        n_pos, n_dir = rngmod.strata_counts(cfg)
        rngmod._check_strata(n_pos, "photon_strata")
        rngmod._check_strata(n_dir, "photon_strata_dir", wide=True)
        rngmod.strata_epoch(cfg, 0)     # the window is a power of two
    if cfg.depth < 1 or cfg.max_photon_bounces < 1:
        raise ValueError("depth and max_photon_bounces must be >= 1")
    if cfg.backend.startswith("wavefront") and cfg.wf_pool < 1:
        raise ValueError(f"wf_pool must be >= 1, got {cfg.wf_pool}")
    if not 0 <= cfg.pallas_bvh_width <= 8:
        raise ValueError(f"pallas_bvh_width must be 0-2 (binary) or 3-8 "
                         f"(wide), got {cfg.pallas_bvh_width}")
