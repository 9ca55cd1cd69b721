"""Mesh construction: debug meshes for tests, production meshes for pods.

The counterpart of ``repro.launch.mesh`` over a torch ``DeviceMesh``:

* ``make_debug_mesh(data, model)``: a small ``("data", "model")`` mesh;
* ``make_production_mesh()``: 16x16 ``("data", "model")``, or 2x16x16
  ``("pod", "data", "model")`` with ``multi_pod``.

Meshes are built by functions, never at import. The device type is
``cuda`` unless the caller asks for ``cpu``. A mesh needs a process group:
ranks started by a launcher (``python -m torch.distributed.run
--standalone --nproc-per-node 8 ...``, which sets ``WORLD_SIZE``,
``RANK`` and the rendezvous address) join the launcher's group from the
environment; otherwise, with no group yet, a world-1 group is started on
a ``HashStore`` (no port, no environment variables). Either group is
started once per process (``nccl`` on the card, ``gloo`` on the CPU)
and never torn down. A mesh larger than the world raises
``RuntimeError("need N devices, have M")``, as the reference's does; it
is never shrunk to fit.

:func:`placeholder_world` is the dry run's: a fake process group of 256
or 512 ranks in one process, which moves no data. No serving or training
entry point calls it.
"""

from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import torch.distributed as dist

from repro_torch.core.emit import DeviceLike, resolve_device

PRODUCTION = (16, 16)
MULTI_POD = (2, 16, 16)


def launched() -> bool:
    """Whether a launcher started this process as one rank of a group
    (``WORLD_SIZE`` and ``RANK`` in the environment)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def world_size() -> int:
    """Ranks in the default process group; with none, the launcher's
    world size, or 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if launched() else 1


def check_world(n: int) -> None:
    """Raise unless the world holds the ``n`` devices a mesh needs."""
    have = world_size()
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")


def _ensure_group(device_type: str) -> None:
    """Start the process group this process meshes over (once): the
    launcher's, from the environment, or a world-1 group."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if launched():
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def placeholder_world(world: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake process group of
    ``world`` ranks (torch's ``fake_pg``): collectives return at once and
    move nothing, so a production mesh can be built, and tensors placed on
    it as meta shards, in one process. For the dry run and its tests
    only; an existing group is replaced."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def build_mesh(shape: Sequence[int], axes: Tuple[str, ...],
               device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks ``0..n-1``
    (rank r in device r's place, row major, as the reference's mesh takes
    ``jax.devices()[:n]``). A ``meta`` plan (the dry run) meshes over CPU
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    check_world(n)
    device_type = resolve_device(device).type
    if device_type == "meta":
        device_type = "cpu"
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
