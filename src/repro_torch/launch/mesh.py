"""Production layouts for the dryrun, on H100s.

The port of ``repro.launch.mesh``.  A layout is device-free
(``utils.sharding.Layout``): the dryrun traces one device's share of a
step on the ``meta`` device, so nothing here touches a card.

The production layouts keep the reference's device counts, 256 and 512,
so per-device figures compare with its TPU meshes.  The model axis is 8,
one NVLink domain of an HGX H100 node: ``data 32 x model 8`` for one pod
and ``pod 2 x data 32 x model 8`` for two.  The dryrun's
``REPRO_DRYRUN_MESH`` and ``REPRO_DRYRUN_MESH_MULTI`` override them as
in the reference; ``REPRO_DRYRUN_DEVICES`` sets XLA's host device count
there and means nothing without XLA, so the port accepts it and ignores
it.
"""
from __future__ import annotations

from repro_torch.utils.sharding import Layout

#: GPUs of one NVLink domain (an HGX H100 node): the model axis
NVLINK_DOMAIN = 8


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    if multi_pod:
        return Layout((2, 32, NVLINK_DOMAIN), ("pod", "data", "model"))
    return Layout((32, NVLINK_DOMAIN), ("data", "model"))


def make_test_mesh(n_data: int = 2, n_model: int = 2) -> Layout:
    """Small layout for CPU tests."""
    return Layout((n_data, n_model), ("data", "model"))


def data_axes(mesh) -> tuple:
    """Batch-sharding axes: ("pod","data") on the multi-pod mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
