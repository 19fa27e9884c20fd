"""Production mesh construction.

``make_production_mesh`` is a FUNCTION (not module-level state), so
importing this module creates no process group and no mesh. The
production meshes are the JAX package's: ``(16, 16)`` over ``("data",
"model")`` on one pod, ``(2, 16, 16)`` over ``("pod", "data", "model")``
across two. They need a world of 256 or 512 ranks: the dry run makes a
fake one (``parallel.dist.fake_world``).
"""
from __future__ import annotations

from repro_torch.parallel.dist import make_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def production_shape(*, multi_pod: bool = False) -> tuple:
    """``(shape, axes)`` of the production mesh."""
    return PRODUCTION[bool(multi_pod)]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = production_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device_type)


def mesh_desc(mesh) -> str:
    return "x".join(f"{n}={s}" for n, s in
                    zip(mesh.mesh_dim_names, mesh.shape))


def n_chips(mesh) -> int:
    return mesh.size()
