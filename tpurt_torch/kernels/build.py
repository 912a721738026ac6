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
        _P,             # geometry tables: a bvh.GeomArgs on the host
        _P,             # rays: one uint64 on the device, added to
        _P,             # CIE table (81, 3) f32 on the host
        _P,             # stream
    ],
    "tpurt_wf_sweep_launch": [
        _P, _P, _P,     # pool in: f32 (13, Q), i32 (3, Q), rng i64 (Q,)
        _P, _P, _P,     # pool out, the same layout
        _P,             # terminated mask, bool (Q,)
        ctypes.c_longlong,  # Q
        _P,             # scene table f32 (device)
        _I, _I, _I,     # n_spheres, n_materials, n_lights
        _I, _F,         # depth, rr_threshold
        _P,             # geometry tables: a bvh.GeomArgs on the host
        _P,             # rays: one uint64 on the device, added to
        _P,             # CIE table (81, 3) f32 on the host
        _P,             # stream
    ],
    "tpurt_wf_fused_launch": [
        _P,             # rgb_sum (P, 3) f32, updated in place
        ctypes.c_longlong,  # pixels to render (the first n rows)
        _I, _I,         # width, height
        _P,             # scene table f32 (device)
        _I, _I, _I,     # n_spheres, n_materials, n_lights
        _U,             # base_seed
        _I, _I,         # spp, iteration (uniform mode)
        _P, _P,         # budgets, base counts i32 (n,): budget mode, or NULL
        _I, _F,         # depth, rr_threshold
        _P,             # geometry tables: a bvh.GeomArgs on the host
        _P,             # rays: one uint64 on the device, added to
        _P,             # CIE table (81, 3) f32 on the host
        _P,             # stream
    ],
    "tpurt_bvh_probe_launch": [
        _P, _P, _P, _P,     # o, d (3, N), t_max, lam (N,) f32
        ctypes.c_longlong,  # N
        _P, _I,             # flat sphere rows (S, 8) f32, S
        _P,                 # geometry tables: a bvh.GeomArgs on the host
        _P, _P, _P, _P, _P,  # out: t, loc (3, N), n (3, N), mat i32, atten
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
