"""The fused trainer (``parallel/fused.py``) and the training mesh of
ranks (``parallel/mesh.py``)."""

from znicz_torch.parallel.mesh import make_mesh  # noqa: F401
