"""Mesh construction: debug meshes for tests, production meshes for pods.

The counterpart of ``repro.launch.mesh`` over a torch ``DeviceMesh``:

* ``make_debug_mesh(data, model)``: a small ``("data", "model")`` mesh;
* ``make_production_mesh()``: 16x16 ``("data", "model")``, or 2x16x16
  ``("pod", "data", "model")`` with ``multi_pod``.

Meshes are built by functions, never at import. The device type is
``cuda`` unless the caller asks for ``cpu``. A mesh needs a process group:
with none yet and a mesh of one device, a world-1 group is started on a
``HashStore`` (``nccl`` on the card, ``gloo`` on the CPU; no port, no
environment variables), once per process, and never torn down. Ranks
started by a launcher bring their own group. A mesh larger than the world
raises ``RuntimeError("need N devices, have M")``, as the reference's
does; it is never shrunk to fit.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch.distributed as dist

from repro_torch.core.emit import DeviceLike, resolve_device

PRODUCTION = (16, 16)
MULTI_POD = (2, 16, 16)


def world_size() -> int:
    """Ranks in the default process group, or 1 with none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def check_world(n: int) -> None:
    """Raise unless the world holds the ``n`` devices a mesh needs."""
    have = world_size()
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")


def _ensure_group(device_type: str) -> None:
    """Start the world-1 process group this process meshes over (once)."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def build_mesh(shape: Sequence[int], axes: Tuple[str, ...],
               device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks ``0..n-1``
    (rank r in device r's place, row major, as the reference's mesh takes
    ``jax.devices()[:n]``)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    check_world(n)
    device_type = resolve_device(device).type
    _ensure_group(device_type)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """16x16 ("data", "model") mesh; 2x16x16 ("pod", "data", "model") with
    ``multi_pod``. Raises ``RuntimeError`` when the world is smaller."""
    if multi_pod:
        return build_mesh(MULTI_POD, ("pod", "data", "model"), device)
    return build_mesh(PRODUCTION, ("data", "model"), device)


def make_debug_mesh(data: int = 1, model: int = 1, *,
                    device: DeviceLike = None):
    """A data x model ("data", "model") mesh (tests, examples, one card)."""
    return build_mesh((data, model), ("data", "model"), device)
