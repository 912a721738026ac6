"""Command-line tools of the port, the twins of tpurt's: ``animate``
(``tools/animate.py``) and ``bake_ao`` (``examples/bake_ao.py``), run as
``python -m tpurt_torch.tools.<name>``; ``scenes`` is their shared scene
and camera setup (``viewer.py _build``)."""
