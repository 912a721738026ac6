"""Same-card A/B of the regen kernel between checkouts of tpurt_torch.

    python3 chip_ab.py PARENT_DIR . . PARENT_DIR

For each checkout given, in the order given (run parent, change, change,
parent), builds that checkout's kernels and prints one line: the regen
kernel's CUDA-event milliseconds per 1080p sample (depth 30, 1 spp, mean of
3 launches after a warm-up) on Cornell, on bench config 6's torus with the
reference sampler, and on the torus with config 6's sampler flags (a
checkout whose kernel takes no flags ignores them: its wrapper is called
directly); then one budget launch on Cornell (seeded budgets 0-2, as many
samples as one uniform sample). Then the card's name and power limit. Needs
one CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

SCRIPT = r'''
import sys
sys.path.insert(0, sys.argv[1])
import torch
import tpurt_torch as tt
from tpurt_torch.kernels import mega_regen
from tpurt_torch.render import state_to_planes

dev = torch.device("cuda")


def ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


torus_cam = ((0, 3, -6), (0, 1.5, 0), 55.0)
shipped = dict(pallas_bvh_leaf=64, photon_strata=16, photon_strata_dir=4096,
               photon_strata_shared_k=True, photon_strata_bounce=True,
               camera_strata_bounce=True, hero_wavelengths=4)
cases = [
    ("cornell", tt.cornell_spheres_scene, {}, ((0, 5, -12), (0, 5, 0), 60.0)),
    ("torus-reference", lambda: tt.torus_mesh_scene(45, 45),
     dict(pallas_bvh_leaf=64), torus_cam),
    ("torus-shipped", lambda: tt.torus_mesh_scene(45, 45), shipped,
     torus_cam),
]
out = []
for name, make, kw, cam in cases:
    cfg = tt.RenderConfig(width=1920, height=1080, depth=30,
                          backend="pallas", **kw)
    scene = make().to(dev)
    camera = tt.make_camera(cam[0], cam[1], vfov=cam[2],
                            aspect_ratio=16 / 9)
    planes = state_to_planes(tt.init_state(cfg, dev))
    t = ms(lambda: mega_regen.regen_call(scene, cfg, camera, planes.clone(),
                                         1234, 1, 0, 2.0, 30))
    out.append(f"{name} {t:.3f}")
    if name == "cornell":
        import numpy as np
        counts = tt.init_state(cfg, dev).n_samples
        vals = np.random.default_rng(7).integers(0, 3, counts.shape[0])
        vals[cfg.n_pixels:] = 0
        budgets = torch.from_numpy(vals).to(dev)
        t = ms(lambda: mega_regen.regen_budget_call(
            scene, cfg, camera, planes.clone(), 1234, budgets, counts))
        out.append(f"cornell-budget {t:.3f}")
print(f"AB {sys.argv[1]}: " + " | ".join(out), flush=True)
'''


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in sys.argv[1:]:
        # one process per checkout: each imports its own tpurt_torch
        subprocess.run([sys.executable, "-c", SCRIPT, tree], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
