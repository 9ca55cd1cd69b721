"""Each rank's slice of every parameter leaf, from JAX and from DTensor.

Run as a script, in a process of its own (``tests/test_torch_dist.py``
does):

    python tests/_torch_dist_layout.py jax OUT.json
        # needs XLA_FLAGS=--xla_force_host_platform_device_count=8
    python tests/_torch_dist_layout.py torch INIT_FILE OUT_DIR

``jax`` writes, for every leaf of the reduced configs of ``ARCHS`` in
every sharding mode on each mesh of ``MESHES``, the reference's
PartitionSpec and ``NamedSharding(mesh, pspec).devices_indices_map``
(device r -> one ``[start, stop)`` per dim). ``torch`` spawns 8 gloo ranks
(rendezvous through ``file://INIT_FILE``) that build the same meshes as
``DeviceMesh``es, rank r in device r's place; each places an ``arange``
tensor of every leaf's shape with the port's ``pspec_to_placements`` and
writes ``rankR.json``: its PartitionSpec, the local shape, and the global
offset read off the local tensor's first element (after checking that the
local tensor is exactly the global tensor's slice there).
"""

import json
import math
import os
import sys

ARCHS = ("yi-6b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b")
MODES = ("cascade", "megatron", "megatron_sp")
MESHES = (("2x4", (2, 4), ("data", "model")),
          ("2x2x2", (2, 2, 2), ("pod", "data", "model")))
WORLD = 8


def jax_layout(out_path):
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding

    from repro.configs import reduced_config
    from repro.dist.sharding import ParamSpec, rules_for_mode, spec_to_pspec
    from repro.models.base import build_model

    devices = jax.devices()
    assert len(devices) >= WORLD, devices
    out = {}
    for mesh_name, shape, axes in MESHES:
        mesh = Mesh(np.asarray(devices[:WORLD]).reshape(shape), axes)
        for arch in ARCHS:
            for mode in MODES:
                cfg = reduced_config(arch).with_(sharding_mode=mode)
                leaves, _ = jax.tree_util.tree_flatten_with_path(
                    build_model(cfg).param_specs(),
                    is_leaf=lambda x: isinstance(x, ParamSpec))
                for path, spec in leaves:
                    pspec = spec_to_pspec(spec, mesh, rules_for_mode(mode))
                    index = NamedSharding(mesh, pspec).devices_indices_map(
                        spec.shape)
                    out["|".join((mesh_name, arch, mode,
                                  jax.tree_util.keystr(path)))] = {
                        "pspec": str(pspec),
                        "slices": {str(d.id): [s.indices(n)[:2] for s, n
                                               in zip(sl, spec.shape)]
                                   for d, sl in index.items()},
                    }
    with open(out_path, "w") as f:
        json.dump(out, f)


def torch_rank(rank, init_file, out_dir):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import reduced_config
    from repro_torch.dist.sharding import (
        pspec_to_placements,
        rules_for_mode,
        spec_to_pspec,
    )
    from repro_torch.models.base import build_model

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD)
    out = {}
    for mesh_name, shape, axes in MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        for arch in ARCHS:
            for mode in MODES:
                cfg = reduced_config(arch).with_(sharding_mode=mode)
                specs = build_model(cfg, device="meta").param_specs()
                for key, spec in specs.items():
                    pspec = spec_to_pspec(spec, mesh, rules_for_mode(mode))
                    full = torch.arange(math.prod(spec.shape)).reshape(
                        spec.shape)
                    local = distribute_tensor(
                        full, mesh, pspec_to_placements(pspec, mesh)
                    ).to_local()
                    offset = [int(i) for i in torch.unravel_index(
                        local.flatten()[0], spec.shape)]
                    window = full[tuple(slice(o, o + n) for o, n
                                        in zip(offset, local.shape))]
                    if not torch.equal(local, window):
                        raise AssertionError(f"rank {rank} {key}: the local "
                                             "tensor is not one slice")
                    out["|".join((mesh_name, arch, mode, key))] = {
                        "pspec": str(pspec), "local": list(local.shape),
                        "offset": offset}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def main(argv):
    if argv[0] == "jax":
        jax_layout(argv[1])
    else:
        import torch.multiprocessing as mp

        mp.spawn(torch_rank, args=(argv[1], argv[2]), nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1:])
