"""Build and load the port's CUDA kernels.

``tpurt_torch/csrc/*.cu`` compile with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and link into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, into ``build/tpurt_torch/`` at the root of the checkout; the
file name carries a hash of the sources and flags, so an edited source
builds anew. FMA contraction and fast math stay off: the
kernels are held to exact ray counts against their plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "tpurt_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xptxas",
              "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# name -> argtypes of every exported launcher (each returns a cudaError_t)
_SIGNATURES = {
    "tpurt_regen_launch": [
        _P,             # planes (16, P) f32, updated in place
        ctypes.c_longlong,  # P
        _I, _I,         # width, height
        _P,             # scene table f32 (device)
        _I, _I, _I,     # n_spheres, n_materials, n_lights
        _U,             # base_seed
        _I, _I, _I,     # spp, iteration, depth
        _F,             # radius at the start of the call
        _I, _I,         # k_photons (0 = off), max_photon_bounces
        _F, _F, _F,     # rr_threshold, photon_rr_threshold, sppm_alpha
        _P,             # sampler switches: a mega_regen.SamplerArgs
        _P,             # aux (3, P) f32 budget, count, radius; NULL: uniform
        _P,             # geometry tables: a bvh.GeomArgs on the host
        _P,             # two uint64 on the device: rays, added to; the work
                        # counter, zeroed on the stream before the launch
        _P,             # CIE table (81, 3) f32 on the device
        _P,             # emission switches: a mega_regen.EmissionArgs, or
                        # NULL (no emission: the instances without it)
        _P,             # spawn switches: a mega_regen.SpawnArgs, or NULL
                        # (no spawn extension, reference roulette)
        _P,             # lights switches: a mega_regen.LightsArgs, or NULL
                        # (NEE over every light, no aimed photons)
        _P,             # two uint64 on the device: the pool instance's warp
                        # trips and busy lanes, added to
        _P,             # stream
    ],
    "tpurt_step_launch": [
        _P,             # planes (16, P) f32, updated in place
        ctypes.c_longlong,  # P
        _I, _I,         # width, height
        _P,             # scene table f32 (device)
        _I, _I, _I,     # n_spheres, n_materials, n_lights
        _U, _I,         # base_seed, iteration of the sample
        _I, _F,         # depth, radius
        _I, _I,         # k_photons (0 = off), max_photon_bounces
        _F, _F,         # rr_threshold, photon_rr_threshold
        _P,             # sampler switches: a mega_regen.SamplerArgs
        _P,             # geometry tables: a bvh.GeomArgs on the host
        _P,             # two uint64 on the device: rays, work counter
        _P,             # CIE table (81, 3) f32 on the device
        _P,             # emission switches: a mega_regen.EmissionArgs, or
                        # NULL (no emission: the instances without it)
        _P,             # spawn switches: a mega_regen.SpawnArgs, or NULL
                        # (no spawn extension, reference roulette)
        _P,             # lights switches: a mega_regen.LightsArgs, or NULL
                        # (NEE over every light, no aimed photons)
        _P,             # stream
    ],
    "tpurt_wf_step_launch": [
        _P, _P, _P,     # pool f32 (13, Q), i32 (3, Q), rng i64 (Q,), in place
        _P, _P,         # rgb_sum (P, 3), n_samples (P,) f32, added to
        _P,             # control words i64 (wavefront.CTL_WORDS + chunks)
        _P,             # scene table f32 (device)
        _I, _I, _I,     # n_spheres, n_materials, n_lights
        _P,             # launch constants: a wavefront_sweep.PoolArgs
        _P,             # geometry tables: a bvh.GeomArgs on the host
        _P,             # CIE table (81, 3) f32 on the device
        _P,             # camera-path sampler switches: a
                        # mega_regen.SamplerArgs (camera_sampler_args)
        _P,             # emission switches: a mega_regen.EmissionArgs, or
                        # NULL (no emission)
        _P,             # spawn switches: a mega_regen.SpawnArgs, or NULL
                        # (no spawn extension, reference roulette)
        _P,             # lights switches: a mega_regen.LightsArgs, or NULL
                        # (NEE over every light, no aimed photons)
        _P,             # stream
    ],
    "tpurt_wf_fused_launch": [
        _P,             # rgb_sum (P, 3) f32, updated in place
        ctypes.c_longlong,  # P, the rows of rgb_sum (aux's stride)
        _I, _I,         # width, height
        _P,             # scene table f32 (device)
        _I, _I, _I,     # n_spheres, n_materials, n_lights
        _U,             # base_seed
        _I, _I,         # spp, iteration (uniform mode)
        _P,             # aux (2, P) f32 budget, count: budget mode, or NULL
        _I, _F,         # depth, rr_threshold
        _P,             # geometry tables: a bvh.GeomArgs on the host
        _P,             # five uint64 on the device, zeroed on the stream
                        # before the launch and added to: rays, the work
                        # counter, warp trips, lanes that traced a segment,
                        # the tail instance's tail segments
        _P,             # CIE table (81, 3) f32 on the device
        _P,             # camera-path sampler switches: a
                        # mega_regen.SamplerArgs (camera_sampler_args)
        _P,             # emission switches: a mega_regen.EmissionArgs, or
                        # NULL (no emission)
        _P,             # spawn switches: a mega_regen.SpawnArgs, or NULL
                        # (no spawn extension, reference roulette)
        _P,             # lights switches: a mega_regen.LightsArgs, or NULL
                        # (NEE over every light, no aimed photons)
        _P,             # stream
    ],
    "tpurt_bvh_probe_launch": [
        _P, _P, _P, _P,     # o, d (3, N), t_max, lam (N,) f32
        ctypes.c_longlong,  # N
        _P, _I,             # flat sphere rows (S, 8) f32, S
        _P,                 # geometry tables: a bvh.GeomArgs on the host
        _P, _P, _P, _P, _P,  # out: t, loc (3, N), n (3, N), mat i32, atten
        _P,                 # G-leaf pairs tested: one uint64 added to, or NULL
        _P,                 # stream
    ],
    "tpurt_tonemap_launch": [
        _P, _P, _P,     # rgb_sum (P, 3), n_samples (P,), out (n, 3)
        _I,             # n pixels
        _F, _F,         # key, saturation
        _P,             # stream
    ],
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = pathlib.Path(cand) / "bin" / "nvcc"
        if cand and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the tpurt_torch "
                           "CUDA kernels are built from source at first use")
    return found


def sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtpurt_torch_{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built if this source state has no build yet.
    Raises if nvcc is missing or the build fails."""
    out = library_path()
    if not out.exists():
        build(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpurt_error_string.argtypes = [ctypes.c_int]
    lib.tpurt_error_string.restype = ctypes.c_char_p
    return lib


def build(out: pathlib.Path) -> None:
    """Compile every csrc/*.cu, in parallel, and link them into ``out``.
    The compilers' resource reports (-Xptxas -v) go to ``out``.log."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = out.with_name(f"{out.stem}.{src.stem}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        logs.append(f"$ {' '.join(cmd)}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text[-4000:]}")
    tmp = out.with_suffix(f".{tag}")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        msg = lib.tpurt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
