"""The scene twins of the plain reference, one file a builder: a
configuration's ``scene.builder`` ``<b>`` is the module ``scenes/<b>.py``
here, imported by name (``twin``), as the harness finds a metric's reader.

A twin holds data only: the scene's description, copied from the port's
preset of that name (``tpurt_torch/scene.py``) and built from the
reference's constructors (``reference/scene.py``). It has

- ``build(**args) -> scene.Desc``, taking the preset's arguments;
- ``SMALL_ARGS``, the scene arguments of the CPU rehearsal at 64x32
  (``bench_torch/rehearse.py``), and ``TINY_ARGS``, those of the fault
  tests at 16x8 (``bench_torch/tests/test_faults.py``): ``{}`` for a
  scene of spheres.

Like every file under ``reference/``, a twin imports nothing of the port.
How a scene is judged is the reference's integrator's and ``check_cfg``'s,
the same for every twin: a twin brings no code of its own for it.
"""

from __future__ import annotations

import collections.abc
import importlib
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
_NAME = re.compile(r"[A-Za-z][A-Za-z0-9_]*\Z")


def twin(builder: str):
    """The twin module of the builder named ``builder``; raises
    LookupError, naming the file it looked for, where there is none."""
    path = HERE / f"{builder}.py"
    if not _NAME.match(builder) or not path.is_file():
        raise LookupError(f"no scene twin for the builder {builder!r}: "
                          f"looked for {path}")
    return importlib.import_module(f"{__name__}.{builder}")


def names() -> list:
    """The builders that have a twin here."""
    return sorted(p.stem for p in HERE.glob("*.py") if _NAME.match(p.stem))


class Builders(collections.abc.Mapping):
    """Each twin's ``build`` by builder name, a read-only view of the
    files here."""

    def __getitem__(self, builder: str):
        try:
            return twin(builder).build
        except LookupError as e:
            raise KeyError(builder) from e

    def __iter__(self):
        return iter(names())

    def __len__(self) -> int:
        return len(names())
