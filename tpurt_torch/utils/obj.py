"""Minimal Wavefront OBJ loader (positions + triangulated faces): a copy
of ``tpurt.utils.obj`` (importing tpurt imports JAX), with the same output.

Equivalent capability to the reference's tobj usage with single_index +
triangulate (ref: src/instance.rs:56-106): only vertex positions matter to
this renderer (no normals/uvs are consumed by the kernels), polygon faces are
fan-triangulated, and 1-based / negative indices are handled per the spec.
"""

from __future__ import annotations

import numpy as np


def parse_obj(path: str):
    """Returns (positions (V, 3) float32, indices (T, 3) int32).

    tpurt's optional native parser gives the same output
    (tests/test_native.py); the port carries only this Python path.
    """
    positions: list[list[float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if parts[0] == "v" and len(parts) >= 4:
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f" and len(parts) >= 4:
                idx = []
                for tok in parts[1:]:
                    vi = tok.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(positions) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    if not positions:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    return (
        np.asarray(positions, np.float32),
        np.asarray(faces, np.int32).reshape(-1, 3),
    )


# ----- MTL material libraries (extension; the reference assigns one material
# per mesh — src/instance.rs:88-92 stores a single material_id per face, and
# the glass.obj call site hard-codes it, src/lib.rs:267-271). tpurt's device
# scene already carries per-triangle material ids (scene.Scene.tri_mat), so
# honoring `mtllib`/`usemtl` is pure host-side loading. -----

def parse_mtl(path: str) -> dict:
    """Parse a .mtl file into {name: fields} dicts.

    Recognized fields: Kd/Ks (RGB), Ns (Phong exponent), Ni (IOR),
    d / Tr (opacity / transparency), illum, and the PBR extensions
    Pr (roughness) / Pm (metallic). Unknown statements are ignored.
    """
    mats: dict[str, dict] = {}
    cur: dict | None = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl" and len(parts) >= 2:
                cur = {}
                mats[parts[1]] = cur
            elif cur is None:
                continue
            elif key in ("Kd", "Ks") and len(parts) >= 4:
                cur[key] = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif key in ("Ns", "Ni", "d", "Pr", "Pm") and len(parts) >= 2:
                cur[key] = float(parts[1])
            elif key == "Tr" and len(parts) >= 2:  # Tr = 1 - d
                cur.setdefault("d", 1.0 - float(parts[1]))
            elif key == "illum" and len(parts) >= 2:
                cur["illum"] = int(float(parts[1]))
    return mats


def mtl_to_material(defn: dict):
    """Map parsed MTL fields onto a tpurt Material.

    Conventions (documented extension — the reference has no MTL path):
    - transmissive (d < 1, a transmissive illum model 4/6/7/9, or Ni > 1.05)
      -> Material.dielectric(ior=Ni or 1.5, roughness=alpha^2) where the GGX
      alpha comes from Pr if present, else the Blinn-Phong conversion
      alpha = sqrt(2/(Ns+2)) (matching the kernel's alpha = sqrt(roughness),
      mega_kernel.wgsl:232).
    - metallic (Pm >= 0.5) -> Material.metal(f0=Ks if lit else Kd, alpha^2).
    - otherwise -> Material.diffuse(Kd, roughness=Pr) with Pr read as the
      Oren-Nayar sigma (0 when absent).
    """
    from tpurt_torch.scene import Material
    kd = defn.get("Kd", (0.8, 0.8, 0.8))
    ks = defn.get("Ks", (0.0, 0.0, 0.0))
    ns = defn.get("Ns", 1000.0)
    ni = defn.get("Ni", 1.0)
    d = defn.get("d", 1.0)
    illum = defn.get("illum", 2)
    if "Pr" in defn:
        alpha = float(np.clip(defn["Pr"], 0.0, 1.0))
    else:
        alpha = float(np.sqrt(2.0 / (max(ns, 0.0) + 2.0)))
    if d < 1.0 or illum in (4, 6, 7, 9) or ni > 1.05:
        return Material.dielectric(ior=ni if ni > 1.0 else 1.5,
                                   roughness=alpha * alpha)
    if defn.get("Pm", 0.0) >= 0.5:
        f0 = ks if max(ks) > 0.0 else kd
        return Material.metal(f0, roughness=alpha * alpha)
    return Material.diffuse(kd, roughness=defn.get("Pr", 0.0))


def parse_obj_mtl(path: str):
    """Parse an OBJ honoring `mtllib`/`usemtl`.

    Returns (positions (V,3) f32, indices (T,3) i32, tri_slot (T,) i32,
    slot_names list[str|None], mtl_defs {name: fields}). tri_slot indexes
    slot_names; slot 0 is always the None slot (faces before any usemtl).
    Pure Python (the native C++ fast path handles only geometry).
    """
    import os
    positions: list[list[float]] = []
    faces: list[tuple[int, int, int]] = []
    face_slot: list[int] = []
    slot_names: list = [None]
    slot_of: dict = {None: 0}
    cur_slot = 0
    mtl_defs: dict = {}
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if parts[0] == "v" and len(parts) >= 4:
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f" and len(parts) >= 4:
                idx = []
                for tok in parts[1:]:
                    vi = tok.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(positions) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
                    face_slot.append(cur_slot)
            elif parts[0] == "mtllib" and len(parts) >= 2:
                # The spec allows several libraries per statement.
                for name in parts[1:]:
                    lib = os.path.join(base_dir, name)
                    if os.path.exists(lib):
                        mtl_defs.update(parse_mtl(lib))
            elif parts[0] == "usemtl" and len(parts) >= 2:
                name = parts[1]
                if name not in slot_of:
                    slot_of[name] = len(slot_names)
                    slot_names.append(name)
                cur_slot = slot_of[name]
    if not positions:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros((0,), np.int32), slot_names, mtl_defs)
    return (
        np.asarray(positions, np.float32),
        np.asarray(faces, np.int32).reshape(-1, 3),
        np.asarray(face_slot, np.int32),
        slot_names,
        mtl_defs,
    )
