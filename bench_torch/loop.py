"""The one job loop every traffic mix runs (closed loop, one client).

A mix is a data file (``traffic/<mix>.json``) with these keys:

- ``state``: ``"window"`` (one fresh accumulation for the whole window,
  made before it opens) or ``"job"`` (a fresh ``init_state`` in each job);
- ``call``: the kind of job, a module ``jobs/<call>.py`` (``render_step``:
  one sample; ``render``: ``spp`` samples in one call), found by name;
- ``seed``: ``"base"`` (every job renders with ``--seed``, as a viewer's
  frames do) or ``"per_job"`` (job j renders with ``job_seed(seed, j)``);
- ``trace``: the slice a traced run profiles, ``skip_jobs`` then ``jobs``;
- ``check_jobs``: how many jobs the check compares.

A job is that call, then ``resolve_image`` and the image copied to host
memory; its time runs from entering the job to the image on the host. The
image lands in one pageable host buffer kept for the run, as a viewer's
framebuffer: a fresh 25 MB host tensor a frame would time the host
allocator, whose first touch of new pages cost some processes ~9 ms a
1080p frame and others none (an H100 machine's host; PERF.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time

import torch

MASK31 = 0x7FFFFFFF


def job_seed(seed: int, j: int) -> int:
    """The base seed of job j of a run (splitmix64 of the pair), below
    2**31."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + j + 1) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & MASK31


@dataclasses.dataclass
class Job:
    t0: float               # host clock at entry
    t1: float               # host clock with the image on the host
    seed: int               # base seed of its render calls
    spp: int                # samples it added to each pixel
    rays: torch.Tensor      # int64 scalar on the device: the state's count
    rows: torch.Tensor | None = None    # the state at the check pixels
    image: torch.Tensor | None = None   # the host image at the check pixels


class Cell:
    """What one run renders: the program's scene, config and camera built
    from a configuration file, and the mix."""

    def __init__(self, tt, config: dict, mix: dict, device):
        self.tt = tt
        self.config = config
        self.mix = mix
        self.device = device
        r = config["render"]
        self.cfg = tt.RenderConfig(**r)
        self.scene = getattr(tt, config["scene"]["builder"])(
            **config["scene"]["args"], device=device)
        c = config["camera"]
        self.camera = tt.make_camera(
            tuple(c["look_from"]), tuple(c["look_at"]), vfov=c["vfov"],
            aspect_ratio=self.cfg.width / self.cfg.height)
        self.job = importlib.import_module(f"bench_torch.jobs.{mix['call']}")
        self.check_pixels = None    # set by the check before a window
        # the host framebuffer, its pages touched here
        self.host = torch.zeros((self.cfg.height, self.cfg.width, 3),
                                dtype=torch.float32)

    def fresh(self):
        return self.tt.init_state(self.cfg, device=self.device)

    def seed_of(self, seed: int, j: int) -> int:
        return int(seed) if self.mix["seed"] == "base" else job_seed(seed, j)


def no_span(name):
    return contextlib.nullcontext()


def state_rows(state, pixels: torch.Tensor) -> torch.Tensor:
    """(S, 17) float32: rgb_sum 3, n_samples, vis_pos 3, vis_norm 3,
    vis_wo 3, vis_tp 3, vis_mat (as float) at the pixels."""
    return torch.cat([state.rgb_sum[pixels], state.n_samples[pixels, None],
                      state.vis_pos[pixels], state.vis_norm[pixels],
                      state.vis_wo[pixels], state.vis_tp[pixels],
                      state.vis_mat[pixels, None].to(torch.float32)], 1)


def one_job(cell: Cell, state, seed: int, span=no_span):
    """Run one job of the mix: one render call, the image resolved and
    copied to the host. Returns (state, host image, spp)."""
    if cell.mix["state"] == "job":
        with span("init_state"):
            state = cell.fresh()
    with span("render"):
        state = cell.job.call(cell, state, seed)
    with span("resolve_image"):
        img = cell.tt.resolve_image(cell.cfg, state)
    with span("to_host"):
        host = cell.host.copy_(img)
    return state, host, cell.job.spp(cell.mix)


def run_window(cell: Cell, seed: int, seconds: float, tracer=None):
    """Jobs until ``seconds`` have passed (and the tracer's slices are
    done). Jobs of a mix with a state per job keep the state and the image
    at the check pixels (``cell.check_pixels``, when set). Returns (jobs,
    t_start, t_end, final state, last host image)."""
    state = cell.fresh() if cell.mix["state"] == "window" else None
    pixels = cell.check_pixels
    host_pixels = None if pixels is None else pixels.cpu()
    jobs = []
    t_start = time.perf_counter()
    j = 0
    while True:
        if tracer is not None:
            tracer.before_job(j)
        span = tracer.span if tracer is not None and tracer.active(j) \
            else no_span
        s = cell.seed_of(seed, j)
        t0 = time.perf_counter()
        with span("job"):
            state, host, spp = one_job(cell, state, s, span)
        t1 = time.perf_counter()
        job = Job(t0, t1, s, spp, state.rays)
        if pixels is not None and cell.mix["state"] == "job":
            job.rows = state_rows(state, pixels)
            job.image = host.reshape(-1, 3)[host_pixels]
        jobs.append(job)
        if tracer is not None:
            tracer.after_job(j, jobs)
        j += 1
        if t1 - t_start >= seconds and (tracer is None or tracer.done()):
            break
    return jobs, t_start, jobs[-1].t1, state, host
