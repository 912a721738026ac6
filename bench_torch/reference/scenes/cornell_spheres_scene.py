"""Twin of ``tpurt_torch.scene.cornell_spheres_scene``: a Cornell box of
radius-1000 sphere walls, a glass, a frosted and a white ball, one square
area light."""

from bench_torch.reference.scene import (Desc, dielectric, diffuse,
                                         no_triangles, square_area)

SMALL_ARGS: dict = {}
TINY_ARGS: dict = {}


def build() -> Desc:
    materials = (diffuse((0.73, 0.73, 0.73)), diffuse((0.65, 0.05, 0.05)),
                 diffuse((0.12, 0.45, 0.15)), dielectric(1.5, 0.0),
                 dielectric(1.5, 0.04))
    R, box = 1000.0, 5.0
    spheres = ((0, R, (0.0, -R, 0.0)), (0, R, (0.0, R + 2 * box, 0.0)),
               (0, R, (0.0, box, R + box)), (1, R, (-R - box, box, 0.0)),
               (2, R, (R + box, box, 0.0)), (3, 1.5, (-1.8, 1.5, 1.0)),
               (4, 1.5, (1.8, 1.5, -0.5)), (0, 1.0, (0.3, 1.0, 2.8)))
    lights = (square_area([0.0, 2 * box - 0.01, 0.0], [0.0, -1.0, 0.0], 1.5,
                          [1.0, 1.0, 1.0], 6.0, 5500.0),)
    return Desc(materials, spheres, lights, **no_triangles())
