"""Twin of ``tpurt_torch.scene.dispersive_scene`` (the scene of tpurt's
bench configs 4 and 5): dispersive crown and flint glass, brushed gold and
two diffuse materials, lit by a 5500 K point light and a 3200 K square
light."""

from bench_torch.reference.scene import (Desc, dielectric, diffuse, metal,
                                         no_triangles, point, square_area)

SMALL_ARGS: dict = {}
TINY_ARGS: dict = {}


def build() -> Desc:
    materials = (diffuse((0.8, 0.8, 0.8)),
                 dielectric(1.52, 0.0),             # crown-glass ball
                 dielectric(1.72, 0.0),             # dense flint
                 metal((1.0, 0.71, 0.29), 0.05),    # brushed gold
                 diffuse((0.3, 0.3, 0.8)))
    spheres = ((0, 1000.0, (0.0, -1000.0, 0.0)), (1, 1.0, (-2.2, 1.0, 4.0)),
               (2, 1.0, (0.0, 1.0, 4.5)), (3, 1.0, (2.2, 1.0, 4.0)),
               (4, 0.7, (0.0, 0.7, 7.0)))
    lights = (point([0.0, 8.0, 0.0], [1.0, 1.0, 1.0], 60.0, 5500.0),
              square_area([6.0, 4.0, 4.0], [-1.0, -0.3, 0.0], 2.0,
                          [1.0, 1.0, 1.0], 4.0, 3200.0))
    return Desc(materials, spheres, lights, **no_triangles())
