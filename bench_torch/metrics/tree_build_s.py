"""tree_build_s: host seconds the program spent in the run's process
building BVH trees and the walk's kernel tables, by its own counter
(``tpurt_torch.accel.BUILD_NS``: ``accel.build_bvh`` and
``kernels/bvh.py``'s geometry builds, a build inside another counted
once): the set-up's builds and any in the window. None on a program
without the counter."""


def read(rec: dict):
    try:
        from tpurt_torch import accel
    except ImportError:
        return None
    ns = getattr(accel, "BUILD_NS", None)
    return None if ns is None else ns * 1e-9
