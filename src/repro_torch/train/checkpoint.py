"""Atomic checkpointing with restore onto a device (the reference's
``repro.train.checkpoint``, on its on-disk layout).

Layout:  <dir>/step_<k>/  shard_<host>.npz  + manifest.json
Writes land in ``step_<k>.tmp`` and are renamed into place only when
complete (a crash mid-save can never corrupt the latest checkpoint). A
state is a nested dict of tensors or numpy arrays; its leaves are stored
under their "/"-joined paths (the reference's keys), bf16 as fp32 (npz
has no bf16), and
``restore`` casts each back through the template's dtype onto a device:
the CPU <-> card form of the reference's elastic restore. Restore across
several cards belongs to the multi-GPU port (ROADMAP Queue 1 item 2).
Retention keeps the newest ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch


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
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {k: _to_numpy(v) for k, v in _flatten(state).items()}
        np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(
                {
                    "step": step,
                    "keys": sorted(arrays.keys()),
                    "treedef": json.dumps(_structure(state), sort_keys=True),
                    "n_hosts": self.n_hosts,
                    "metadata": metadata or {},
                },
                f,
            )
        if os.path.exists(final):  # overwrite: the new one replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

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
                device=None) -> Dict[str, Any]:
        """The checkpoint of ``step`` in the structure of ``template``, a
        nested dict of tensors (the meta device is fine: only their shapes
        and dtypes are read). Each leaf comes back as a tensor of its
        template's dtype on ``device``, or on the template leaf's own
        device when ``device`` is None (the CPU for a meta leaf)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        data = np.load(os.path.join(path, f"shard_{self.host_id}.npz"))

        def one(key: str, leaf: torch.Tensor) -> torch.Tensor:
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"template {tuple(leaf.shape)}")
            dev = device if device is not None else (
                "cpu" if leaf.device.type == "meta" else leaf.device)
            return torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)

        def walk(tree, prefix=""):
            return {k: walk(v, _key(prefix, k) + "/")
                    if isinstance(v, Mapping) else one(_key(prefix, k), v)
                    for k, v in tree.items()}

        with data:
            return walk(template)

    def metadata(self, step: int) -> Dict:
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f).get("metadata", {})
