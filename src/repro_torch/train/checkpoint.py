"""Atomic checkpointing with restore onto a device or a mesh (the
reference's ``repro.train.checkpoint``, on its on-disk layout).

Layout:  <dir>/step_<k>/  shard_<host>.npz  + manifest.json
Writes land in ``step_<k>.tmp`` and are renamed into place only when
complete (a crash mid-save can never corrupt the latest checkpoint). A
state is a nested dict of tensors or numpy arrays; its leaves are stored
under their "/"-joined paths (the reference's keys), bf16 as fp32 (npz
has no bf16), and ``restore`` casts each back through the template's
dtype onto a device. Retention keeps the newest ``keep`` checkpoints.

On a mesh the file is the same: ``save`` gathers each DTensor leaf whole
(``full_tensor()``, a collective every rank joins, in the state's
order), rank 0 of the process group writes, and the rename runs after a
barrier. ``restore(..., shardings=)`` places each leaf at the
``(mesh, placements)`` given for it (each rank keeps its own shard of
the file, no data moves), and a DTensor leaf of the template is placed
at the template's own placements: a plain checkpoint restores onto a
mesh, onto another mesh (elastic scaling), and back.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import is_dtensor, local_value, place


def _key(prefix: str, key: str) -> str:
    """A leaf's path: "/"-joined keys; a "." inside a key (the optimizer
    state's leaf names, ``blocks.attn.wq.w``) is a level of the path too,
    so the keys are the reference's."""
    return prefix + key.replace(".", "/")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = _key(prefix, key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = val
    return out


def _structure(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The tree's shape with every leaf as "*" (the manifest's
    ``treedef``)."""
    return {k: _structure(v) if isinstance(v, Mapping) else "*"
            for k, v in tree.items()}


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def _read_arrays(npz: str, keys: List[str], workers: int = 8
                 ) -> Dict[str, np.ndarray]:
    """``{key: array}`` of an npz that ``np.savez`` wrote, several members
    at a time: a stored (uncompressed) member is read from its offset with
    one ``np.fromfile`` and its CRC-32 checked, as ``zipfile`` checks it;
    the reads and the checksums release the GIL. A compressed member goes
    through ``np.load``."""
    with zipfile.ZipFile(npz) as zf:
        infos = {k: zf.getinfo(k + ".npy") for k in keys}

    def one(key: str) -> np.ndarray:
        info = infos[key]
        if info.compress_type != zipfile.ZIP_STORED:
            with np.load(npz) as data:
                return data[key]
        with open(npz, "rb") as f:
            f.seek(info.header_offset)
            head = f.read(30)              # the member's local file header
            if head[:4] != b"PK\x03\x04":
                raise ValueError(f"{npz}: no local header for {key}")
            start = (info.header_offset + 30
                     + int.from_bytes(head[26:28], "little")
                     + int.from_bytes(head[28:30], "little"))
            f.seek(start)
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = (
                np.lib.format.read_array_header_1_0(f) if version == (1, 0)
                else np.lib.format.read_array_header_2_0(f))
            header_len = f.tell() - start
            f.seek(start)
            crc = zlib.crc32(f.read(header_len))
            count = math.prod(shape)
            arr = np.fromfile(f, dtype=dtype, count=count)
        if arr.size != count:
            raise ValueError(f"{npz}: {key} is truncated")
        if zlib.crc32(arr.view(np.uint8), crc) != info.CRC:
            raise ValueError(f"{npz}: bad CRC-32 for {key}")
        return arr.reshape(shape, order="F" if fortran else "C")

    with ThreadPoolExecutor(max_workers=max(1, min(workers, len(keys)))) \
            as pool:
        return dict(zip(keys, pool.map(one, keys)))


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, host_id: int = 0,
                 n_hosts: int = 1):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, state: Mapping[str, Any],
             metadata: Optional[Dict] = None):
        flat = _flatten(state)
        collective = any(is_dtensor(v) for v in flat.values())
        # every rank gathers every DTensor leaf (a collective), in order
        arrays = {k: _to_numpy(local_value(v) if is_dtensor(v) else v)
                  for k, v in flat.items()}
        writer = not collective or _rank() == 0
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if writer:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"),
                     **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(
                    {
                        "step": step,
                        "keys": sorted(arrays.keys()),
                        "treedef": json.dumps(_structure(state),
                                              sort_keys=True),
                        "n_hosts": self.n_hosts,
                        "metadata": metadata or {},
                    },
                    f,
                )
        del arrays
        if collective:
            _barrier()
        if writer:
            if os.path.exists(final):  # overwrite: the new one replaces it
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
        if collective:
            _barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Mapping[str, Any],
                device=None, shardings: Optional[Mapping[str, Any]] = None
                ) -> Dict[str, Any]:
        """The checkpoint of ``step`` in the structure of ``template``, a
        nested dict of tensors (the meta device is fine: only their shapes
        and dtypes are read). Each leaf comes back as a tensor of its
        template's dtype on ``device``, or on the template leaf's own
        device when ``device`` is None (the CPU for a meta leaf).

        ``shardings`` mirrors ``template`` (a missing key, or a None leaf,
        means no sharding given); a ``(mesh, placements)`` leaf places
        that leaf there as a DTensor on the mesh's device type. A DTensor
        template leaf with no sharding given is placed at its own mesh
        and placements."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        data = _read_arrays(os.path.join(path, f"shard_{self.host_id}.npz"),
                            list(_flatten(template)))

        def one(key: str, leaf: torch.Tensor, sharding) -> torch.Tensor:
            arr = data.pop(key)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"template {tuple(leaf.shape)}")
            if sharding is None and is_dtensor(leaf):
                sharding = (leaf.device_mesh, leaf.placements)
            if sharding is not None:
                mesh, placements = sharding
                dev = device if device is not None else mesh.device_type
                return place(torch.from_numpy(arr).to(
                    device=dev, dtype=leaf.dtype), mesh, placements)
            dev = device if device is not None else (
                "cpu" if leaf.device.type == "meta" else leaf.device)
            return torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)

        def walk(tree, shards, prefix=""):
            shards = shards or {}
            return {k: walk(v, shards.get(k), _key(prefix, k) + "/")
                    if isinstance(v, Mapping)
                    else one(_key(prefix, k), v, shards.get(k))
                    for k, v in tree.items()}

        return walk(template, shardings)

    def metadata(self, step: int) -> Dict:
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f).get("metadata", {})
