"""``render_step``: one sample a job with the job's base seed, as a
viewer's frame (``viewer.py``)."""


def spp(mix: dict) -> int:
    """Samples a job adds to each pixel."""
    return 1


def call(cell, state, seed: int):
    """The state after the job's render call."""
    return cell.tt.render_step(cell.scene, cell.cfg, cell.camera, state,
                               seed)
