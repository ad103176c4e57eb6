"""Production meshes (port of ``repro.launch.mesh``).

Functions, never module-level constants.  By default they return
:class:`sharding.AbstractMesh`es (named axis sizes, no devices, no
processes), which is all the rule tables, the specs and the dry-run read,
so importing or calling them touches no device.  ``real=True`` builds the
``DeviceMesh`` of the same shape over the processes of the initialised
default group (NCCL on the cards, ``device_type="cpu"`` under gloo).
"""
from __future__ import annotations

from repro_torch import sharding as shd


def make_production_mesh(*, multi_pod: bool = False, real: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 chips.
    Multi-pod: (pod=2, data=16, model=16) = 512 chips; ``pod`` is the
    slow axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if real:
        return shd.mesh_nd(shape, axes, device_type)
    return shd.AbstractMesh(shape, axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model")):
    """A small abstract mesh."""
    return shd.AbstractMesh(tuple(shape), tuple(axes))


def device_count_required(multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256
