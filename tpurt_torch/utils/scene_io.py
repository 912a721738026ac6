"""JSON scene files (``tpurt.utils.scene_io``, the same schema):
``load_scene_json`` builds a ``Scene`` from a file, ``save_scene_json``
writes one back.

Schema (all vectors are 3-lists, all fields of each record shown):

    {
      "materials": [
        {"type": "diffuse",    "color": [r,g,b], "roughness": 0.0},
        {"type": "dielectric", "ior": 1.5,       "roughness": 0.01},
        {"type": "metal",      "color": [r,g,b], "roughness": 0.1},
        {"type": "emissive",   "color": [r,g,b], "intensity": 10.0}
      ],
      "spheres": [
        {"material": 0, "radius": 1.0, "center": [x,y,z]}
      ],
      "meshes": [
        {"material": 1, "translation": [x,y,z], "rotation_deg": 0.0,
         "scale": 1.0, "obj": "path/to/model.obj", "use_mtl": false},
        {"material": 1, "positions": [[x,y,z], ...],
         "indices": [[i0,i1,i2], ...]}
      ],
      "lights": [
        {"type": "point",  "position": [x,y,z], "color": [r,g,b],
         "intensity": 10.0, "color_temp": 5500.0},
        {"type": "square", "position": [x,y,z], "normal": [x,y,z],
         "half_width": 3.0, "color": [r,g,b], "intensity": 5.0,
         "color_temp": 5500.0}
      ],
      "camera": {"eye": [x,y,z], "look_at": [x,y,z], "vfov": 60.0,
                 "aperture": 0.0, "focus_dist": 10.0}
    }

``camera`` is optional metadata returned beside the scene. OBJ paths are
resolved relative to the JSON file's directory.
"""

from __future__ import annotations

import json
import os

import numpy as np

from tpurt_torch.scene import (Light, Material, MeshData, Scene, Sphere,
                               build_scene)

_MTYPES = {0: "diffuse", 1: "dielectric", 2: "metal", 3: "emissive"}


def load_scene_json(path: str, device=None):
    """Parse a JSON scene file -> (Scene, camera dict | None). The Scene
    is built on ``device``, the CUDA card unless the caller asks for
    another (``device="cpu"``), as ``build_scene`` does."""
    with open(path) as f:
        doc = json.load(f)
    base = os.path.dirname(os.path.abspath(path))

    materials = []
    for m in doc.get("materials", []):
        kind = m.get("type", "diffuse")
        if kind == "diffuse":
            materials.append(Material.diffuse(m.get("color", (0.8, 0.8, 0.8)),
                                              float(m.get("roughness", 0.0))))
        elif kind == "dielectric":
            materials.append(Material.dielectric(
                float(m.get("ior", 1.5)), float(m.get("roughness", 0.0))))
        elif kind == "metal":
            materials.append(Material.metal(m.get("color", (0.9, 0.9, 0.9)),
                                            float(m.get("roughness", 0.0))))
        elif kind == "emissive":
            materials.append(Material.emissive(
                m.get("color", (1.0, 1.0, 1.0)),
                float(m.get("intensity", 1.0))))
        else:
            raise ValueError(f"unknown material type {kind!r}")

    spheres = [Sphere(int(sp.get("material", 0)), float(sp["radius"]),
                      tuple(sp["center"]))
               for sp in doc.get("spheres", [])]

    meshes = []
    for me in doc.get("meshes", []):
        mesh = MeshData(material_id=int(me.get("material", 0)),
                        translation=tuple(me.get("translation", (0, 0, 0))),
                        rotation_deg=float(me.get("rotation_deg", 0.0)),
                        scale=float(me.get("scale", 1.0)))
        if "obj" in me:
            # with use_mtl, the mtllib/usemtl materials append to the
            # document's list; "material" stays the fallback
            mesh.load_obj(os.path.join(base, me["obj"]),
                          materials=materials if me.get("use_mtl", False)
                          else None)
        else:
            mesh.add_triangles(np.asarray(me["positions"], np.float32),
                               np.asarray(me["indices"], np.int32))
        meshes.append(mesh)

    lights = []
    for lt in doc.get("lights", []):
        kind = lt.get("type", "point")
        if kind == "point":
            lights.append(Light.point(lt["position"],
                                      lt.get("color", (1.0, 1.0, 1.0)),
                                      float(lt.get("intensity", 1.0)),
                                      float(lt.get("color_temp", 0.0))))
        elif kind == "square":
            lights.append(Light.square_area(
                lt["position"], lt.get("normal", (0.0, -1.0, 0.0)),
                float(lt.get("half_width", 1.0)),
                lt.get("color", (1.0, 1.0, 1.0)),
                float(lt.get("intensity", 1.0)),
                float(lt.get("color_temp", 0.0))))
        else:
            raise ValueError(f"unknown light type {kind!r}")

    n_mats = len(materials) or 1
    for what, items in (("sphere", spheres), ("mesh", meshes)):
        for it in items:
            if not 0 <= it.material_id < n_mats:
                raise ValueError(
                    f"{what} material {it.material_id} out of range "
                    f"(have {n_mats} materials)")

    return (build_scene(materials, spheres, meshes, lights, device=device),
            doc.get("camera"))


def save_scene_json(path: str, scene: Scene, camera: dict | None = None
                    ) -> None:
    """Write a Scene back in the schema. Meshes go out as inline
    positions/indices, three vertices per triangle rebuilt from the
    stored (a, e1, e2) in float64 and not deduplicated; a reload derives
    the edges again from those vertices, so geometry matches up to ~1 ulp
    of the vertex magnitude."""
    s = {k: v.detach().cpu().numpy() for k, v in scene.tensors().items()}
    mats = []
    for i in range(s["mat_color"].shape[0]):
        kind = _MTYPES[int(s["mat_type"][i])]
        rec = {"type": kind, "roughness": float(s["mat_rough"][i])}
        if kind == "dielectric":
            rec["ior"] = float(s["mat_ior"][i])
        else:
            rec["color"] = [float(x) for x in s["mat_color"][i]]
        mats.append(rec)

    sphs = [{"material": int(s["sph_mat"][i]),
             "radius": float(s["sph_radius"][i]),
             "center": [float(x) for x in s["sph_center"][i]]}
            for i in range(scene.num_spheres)]

    doc = {"materials": mats, "spheres": sphs, "meshes": [], "lights": []}
    if scene.num_triangles:
        a = s["tri_a"].astype(np.float64)
        e1 = s["tri_e1"].astype(np.float64)
        e2 = s["tri_e2"].astype(np.float64)
        tm = s["tri_mat"]
        for mat in sorted(set(int(x) for x in tm)):
            sel = np.flatnonzero(tm == mat)
            pos = np.concatenate([a[sel], a[sel] + e1[sel],
                                  a[sel] + e2[sel]], axis=1).reshape(-1, 3)
            idx = np.arange(pos.shape[0], dtype=np.int32).reshape(-1, 3)
            doc["meshes"].append({
                "material": mat,
                "positions": [[float(x) for x in p] for p in pos],
                "indices": [[int(x) for x in t] for t in idx],
            })

    for j in range(scene.num_lights):
        kind = "point" if int(s["light_type"][j]) == 0 else "square"
        rec = {"type": kind,
               "position": [float(x) for x in s["light_pos"][j]],
               "color": [float(x) for x in s["light_color"][j]],
               "intensity": float(s["light_intensity"][j]),
               "color_temp": float(s["light_temp"][j])}
        if kind == "square":
            rec["half_width"] = float(s["light_hw"][j])
            rec["normal"] = [float(x) for x in s["light_normal"][j]]
        doc["lights"].append(rec)
    if camera:
        doc["camera"] = camera
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
