"""How ``correct`` is decided: what the timed path produced, against the
plain reference (``bench_torch/reference``), once the window has closed.

Pixels are answers that can be checked one by one. The check draws from
the seed one pixel in each cell of a grid over the image (a stratified
sample) and a few of the window's jobs (``check_jobs`` of the mix; a view
window is one job), and compares at those pixels the state the path
kernels left (rgb_sum, n_samples and the vispoint planes) and the image
the blit produced and the host received. With ``reference_full_frame``
in the configuration, a view window's first frame is also traced whole by
the reference, and its exact ray count compared. The pixels' lanes are
capped by the configuration's ``reference_lanes``.

The reference renders the configuration's scene from its twin, the file
``reference/scenes/<builder>.py`` found by the name of the
configuration's ``scene.builder``, with the one integrator and the one
knob check (``reference/integrate.py check_cfg``) that every
configuration shares. Every number compared has its limit in
``limits/<workload>.json``; a number at or under its limit passes.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench_torch import loop
from bench_torch.reference import fmath
from bench_torch.reference import integrate as ref
from bench_torch.reference import scene as ref_scene
from bench_torch.reference import tonemap as ref_tm
from bench_torch.reference.scenes import twin

MIN_PIXELS = 16


def grid_pixels(seed: int, width: int, height: int, count: int
                ) -> torch.Tensor:
    """At least ``count`` linear pixel indices (all of them where the image
    has fewer), one drawn from the seed in each cell of a grid shaped like
    the image."""
    gy = max(1, min(height, round(math.sqrt(count * height / width))))
    gx = max(1, min(width, -(-count // gy)))
    gy = max(gy, min(height, -(-count // gx)))
    rng = np.random.default_rng([int(seed), 0xC4EC])
    xs = np.linspace(0, width, gx + 1).astype(np.int64)
    ys = np.linspace(0, height, gy + 1).astype(np.int64)
    out = []
    for j in range(gy):
        for i in range(gx):
            x = rng.integers(xs[i], max(xs[i + 1], xs[i] + 1))
            y = rng.integers(ys[j], max(ys[j + 1], ys[j] + 1))
            out.append(int(y) * width + int(x))
    return torch.tensor(sorted(set(out)), dtype=torch.int64)


def pixel_count(config: dict, spp: int, jobs: int) -> int:
    """Pixels a check samples: the reference's lanes over the samples it
    traces per pixel."""
    return max(MIN_PIXELS,
               int(config["reference_lanes"]) // max(1, spp * jobs))


def checked_jobs(seed: int, n_jobs: int, k: int) -> list:
    """k distinct job indices of the window drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0x10B5])
    return sorted(rng.choice(n_jobs, size=min(k, n_jobs),
                             replace=False).tolist())


def program_outputs(cell, jobs, state, host, seed: int) -> dict:
    """What the window produced at the check's pixels and jobs."""
    mix, cfg = cell.mix, cell.cfg
    if mix["state"] == "window":
        spp = sum(j.spp for j in jobs)
        pixels = grid_pixels(seed, cfg.width, cfg.height,
                             pixel_count(cell.config, spp, 1))
        rows = loop.state_rows(state, pixels.to(state.device))
        out = {"pixels": pixels, "jobs": [dict(
            seed=jobs[0].seed, spp=spp, rows=rows.float().cpu(),
            image=host.reshape(-1, 3)[pixels].float())]}
        if cell.config.get("reference_full_frame"):
            out["first_frame"] = dict(seed=jobs[0].seed,
                                      rays=int(jobs[0].rays))
        return out
    picked = checked_jobs(seed, len(jobs), int(mix["check_jobs"]))
    return {"pixels": cell.check_pixels.cpu(), "jobs": [dict(
        seed=jobs[i].seed, spp=jobs[i].spp, rows=jobs[i].rows.float().cpu(),
        image=jobs[i].image.float()) for i in picked]}


def job_pixels(cell, seed: int) -> torch.Tensor:
    """The check's pixels of a mix with a state per job, drawn before the
    window (its jobs keep their state there)."""
    cfg = cell.cfg
    return grid_pixels(seed, cfg.width, cfg.height,
                       pixel_count(cell.config, cell.job.spp(cell.mix),
                                   int(cell.mix["check_jobs"])))


def reference_outputs(config: dict, prog: dict, device,
                      dtype=torch.float32) -> dict:
    """The plain reference's outputs for the program's checked pixels and
    jobs, computed in ``dtype`` (float32; bfloat16 for the control)."""
    r = config["render"]
    rcfg = ref.check_cfg(r)
    desc = twin(config["scene"]["builder"]).build(**config["scene"]["args"])
    cam_rows = camera_rows(config, rcfg)
    pixels = prog["pixels"].to(device)
    out = {"pixels": prog["pixels"], "jobs": []}
    with fmath.precision(dtype):
        fs = ref_scene.freeze(desc, device)
        for job in prog["jobs"]:
            res = ref.render_lanes(fs, rcfg, cam_rows, pixels, job["seed"],
                                   job["spp"])
            rows = torch.cat([res["rgb_sum"], res["n_samples"][:, None],
                              res["vis"]], 1)
            img = ref_tm.tonemap(ref_tm.resolve(res["rgb_sum"],
                                                res["n_samples"]),
                                 rcfg.tonemap_key, rcfg.tonemap_saturation)
            out["jobs"].append(dict(seed=job["seed"], spp=job["spp"],
                                    rows=rows.float().cpu(),
                                    image=img.float().cpu()))
            del res
        if "first_frame" in prog:
            every = torch.arange(rcfg.width * rcfg.height, device=device)
            rays = 0
            for part in every.split(1 << 21):
                rays += int(ref.render_lanes(
                    fs, rcfg, cam_rows, part, prog["first_frame"]["seed"],
                    1)["rays"].sum())
            out["first_frame"] = dict(rays=rays)
    return out


def camera_rows(config: dict, rcfg) -> np.ndarray:
    """(4, 3) float32 camera rows: origin, horizontal, vertical,
    lower_left (the RTiOW basis, as the port's make_camera builds it)."""
    c = config["camera"]
    look_from = np.asarray(c["look_from"], np.float32)
    look_at = np.asarray(c["look_at"], np.float32)
    v_up = np.asarray((0.0, 1.0, 0.0), np.float32)
    h = math.tan(c["vfov"] * math.pi / 180.0 / 2.0)
    vh = 2.0 * h
    vw = rcfg.width / rcfg.height * vh
    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(w, v_up)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    horizontal = vw * u
    vertical = vh * v
    lower_left = look_from - 0.5 * horizontal - 0.5 * vertical - w
    return np.stack([np.asarray(x, np.float32) for x in
                     (look_from, horizontal, vertical, lower_left)])


def compare(prog: dict, want: dict) -> dict:
    """The numbers compared: ``state_gap``, the largest gap of a state
    value at a checked pixel over the largest magnitude of that value
    there; ``image_gap``, the largest absolute gap of an image value;
    ``rays_gap`` (with a whole first frame), the first frame's segments
    apart."""
    state_gap = image_gap = 0.0
    for p, r in zip(prog["jobs"], want["jobs"]):
        scale = r["rows"].abs().amax(dim=0).clamp_min(1e-30)
        gap = ((p["rows"] - r["rows"]).abs().amax(dim=0) / scale).max()
        state_gap = max(state_gap, float(gap))
        image_gap = max(image_gap,
                        float((p["image"] - r["image"]).abs().max()))
    out = {"state_gap": state_gap, "image_gap": image_gap}
    if "first_frame" in prog:
        out["rays_gap"] = float(abs(prog["first_frame"]["rays"]
                                    - want["first_frame"]["rays"]))
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number beside its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    bad = [k for k, c in checks.items()
           if not (math.isfinite(c["value"]) and c["value"] <= c["limit"])]
    return not bad, checks


def run_check(config, prog, device, limits) -> tuple:
    """(correct, checks, seconds the reference took)."""
    t0 = time.perf_counter()
    want = reference_outputs(config, prog, device)
    numbers = compare(prog, want)
    return (*judge(numbers, limits), time.perf_counter() - t0)
