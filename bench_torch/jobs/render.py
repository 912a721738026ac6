"""``render``: the mix's ``spp`` samples in one call with the job's base
seed, as a still (``bench.py``'s steady state)."""


def spp(mix: dict) -> int:
    """Samples a job adds to each pixel."""
    return int(mix["spp"])


def call(cell, state, seed: int):
    """The state after the job's render call."""
    return cell.tt.render(cell.scene, cell.cfg, cell.camera, state, seed,
                          spp(cell.mix))
