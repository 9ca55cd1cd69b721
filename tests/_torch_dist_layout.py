"""Each rank's slice of every parameter leaf, from JAX and from DTensor.

Run as a script, in a process of its own (``tests/test_torch_dist.py``
does):

    python tests/_torch_dist_layout.py jax OUT.json
        # needs XLA_FLAGS=--xla_force_host_platform_device_count=8
    python tests/_torch_dist_layout.py torch INIT_FILE OUT_DIR
    python tests/_torch_dist_layout.py staged OUT_DIR

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

With two stages (PlaceStages: ``layers -> data``) ``jax`` also writes
``OUT.staged.json``: for the same archs, modes and meshes, every leaf's
PartitionSpec and slices under the reference plan's rules, and those of
the decode state (dense, the draft's twins where the family has them,
and the page pool). ``staged`` runs ranks 0-7 one after the other in one
process, each as a rank of torch's fake process group (nothing moves
between ranks), and places the port's staged plan: an ``arange`` of every
stacked leaf split into its members goes through
``ExecutionPlan.iter_shard_params`` (each staged member onto its band),
the decode state through the plan's placement. Each rank writes
``staged_rankR.json``: its PartitionSpec, the shape, and the box its held
members and their blocks make in the stacked leaf (checked to be exactly
that slice; a member it does not hold must be empty).
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
    with open(staged_path(out_path), "w") as f:
        json.dump(jax_staged(mesh_of=lambda shape, axes: Mesh(
            np.asarray(devices[:WORLD]).reshape(shape), axes)), f)


STATE = dict(batch=4, max_len=16, paged=(8, 4), draft_layers=2)
DRAFT_FAMILIES = ("dense", "moe")


def staged_path(out_path):
    return str(out_path) + ".staged.json"


def jax_staged(mesh_of):
    """``{mesh|arch|mode|leaf: {"pspec", "shape", "slices"}}`` of the
    reference's two-stage plan: every parameter leaf and every leaf of the
    decode state."""
    import jax
    from jax.sharding import NamedSharding

    from repro.configs import reduced_config
    from repro.dist.sharding import ParamSpec, spec_to_pspec
    from repro.models.base import (
        build_model,
        paged_state_specs,
        spec_state_specs,
    )
    from repro.plan import MeshSpec, build_plan

    out = {}
    for mesh_name, shape, axes in MESHES:
        mesh = mesh_of(shape, axes)
        for arch in ARCHS:
            for mode in MODES:
                cfg = reduced_config(arch).with_(sharding_mode=mode)
                plan = build_plan(cfg, None, mesh_spec=MeshSpec.from_mesh(
                    mesh), pipeline_stages=2)
                assert plan.ir.stage_axis == "data", (arch, mesh_name)
                model = build_model(cfg)
                leaves, _ = jax.tree_util.tree_flatten_with_path(
                    model.param_specs(),
                    is_leaf=lambda x: isinstance(x, ParamSpec))
                specs = {jax.tree_util.keystr(p): s for p, s in leaves}
                for name, s in state_specs_ref(
                        model, cfg, paged_state_specs,
                        spec_state_specs).items():
                    specs["state:" + name] = s
                for key, spec in specs.items():
                    pspec = spec_to_pspec(spec, mesh, plan.rules)
                    index = NamedSharding(mesh, pspec).devices_indices_map(
                        spec.shape)
                    out["|".join((mesh_name, arch, mode, key))] = {
                        "pspec": str(pspec), "shape": list(spec.shape),
                        "slices": {str(d.id): [s.indices(n)[:2] for s, n
                                               in zip(sl, spec.shape)]
                                   for d, sl in index.items()},
                    }
    return out


def state_specs_ref(model, cfg, paged_state_specs, spec_state_specs):
    """The reference's decode-state specs of :data:`STATE`: the dense
    state (with the draft's twins for the LM families) and the page
    pool, keyed ``dense:`` and ``paged:``."""
    sspecs = model.decode_state_specs(STATE["batch"], STATE["max_len"])
    dense = dict(sspecs)
    if cfg.family in DRAFT_FAMILIES:
        dense.update(spec_state_specs(sspecs, STATE["draft_layers"]))
    pool = paged_state_specs(sspecs, *STATE["paged"])
    out = {f"dense:{k}": v for k, v in dense.items()}
    out.update({f"paged:{k}": v for k, v in pool.items()
                if k in ("cache_k", "cache_v")})
    return out


def torch_staged(out_dir):
    """Ranks 0-7 of a fake process group, one after the other: each
    places the port's two-stage plan and writes what it holds."""
    import torch

    from repro_torch.bridge import leaf_groups
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import build_mesh, placeholder_world
    from repro_torch.dist.sharding import spec_to_pspec
    from repro_torch.models.base import (
        build_model,
        leaf_key,
        port_layout,
        state_specs,
    )
    from repro_torch.plan import MeshSpec, build_plan

    torch.set_num_threads(1)
    for rank in range(WORLD):
        placeholder_world(WORLD, rank)
        out = {}
        for mesh_name, shape, axes in MESHES:
            mesh = build_mesh(shape, axes, device="cpu")
            for arch in ARCHS:
                for mode in MODES:
                    cfg = reduced_config(arch).with_(sharding_mode=mode)
                    plan = build_plan(cfg, mode=mode,
                                      mesh_spec=MeshSpec.from_mesh(mesh),
                                      pipeline_stages=2, device="cpu")
                    prefix = "|".join((mesh_name, arch, mode))
                    model = build_model(cfg, device="cpu",
                                        dtype=torch.float64)
                    params = dict(model.named_parameters())
                    full = {}
                    with torch.no_grad():
                        for g in leaf_groups(model):
                            first = params[g.members[0]]
                            leaf = torch.arange(
                                math.prod(g.stack) * first.numel(),
                                dtype=torch.float64).reshape(
                                    *g.stack, *first.shape)
                            full[g.name] = leaf
                            rows = leaf.reshape(-1, *first.shape)
                            for i, n in enumerate(g.members):
                                params[n].copy_(rows[i])
                    placed = dict(plan.iter_shard_params(model))
                    for g in leaf_groups(model):
                        out[f"{prefix}|{leaf_key(g.name)}"] = _held(
                            full[g.name], [placed[n] for n in g.members],
                            g.stack, plan.ir.param_pspecs[leaf_key(g.name)])
                    meta = build_model(cfg, device="meta")
                    for kind, paged in (("dense", None),
                                        ("paged", STATE["paged"])):
                        draft = (STATE["draft_layers"] if kind == "dense"
                                 and cfg.family in DRAFT_FAMILIES else 0)
                        zero = meta.decode_state(
                            STATE["batch"], STATE["max_len"], paged=paged,
                            draft_layers=draft)
                        if paged is not None:
                            zero = {k: v for k, v in zero.items()
                                    if k in ("cache_k", "cache_v")}
                        specs = state_specs(
                            meta, STATE["batch"], STATE["max_len"],
                            paged=paged, draft_layers=draft)
                        state = {k: torch.arange(v.numel(),
                                                 dtype=torch.float64
                                                 ).reshape(v.shape)
                                 for k, v in zero.items()}
                        placed = plan._place_state(
                            state, {k: specs[k] for k in state})
                        for k, v in placed.items():
                            pspec = spec_to_pspec(port_layout(
                                specs[k], tuple(v.shape)), mesh, plan.rules)
                            out[f"{prefix}|state:{kind}:{k}"] = _held(
                                state[k], [v.to_local()], (), str(pspec))
        with open(os.path.join(out_dir, f"staged_rank{rank}.json"),
                  "w") as f:
            json.dump(out, f)


def _held(full, members, stack, pspec):
    """What a rank holds of the stacked leaf ``full``: the box its
    non-empty members (``members`` in stack order, DTensors or plain
    locals) and their blocks make, checked to be exactly ``full``'s slice
    there."""
    import torch

    locals_ = [m.to_local() if hasattr(m, "to_local") else m
               for m in members]
    held = [(i, t) for i, t in enumerate(locals_) if t.numel() > 0]
    idx = [tuple(int(j) for j in torch.unravel_index(torch.tensor(i),
                                                     stack)) if stack
           else () for i, _ in held]
    lo = [min(c[d] for c in idx) for d in range(len(stack))]
    hi = [max(c[d] for c in idx) + 1 for d in range(len(stack))]
    if math.prod(h - l for l, h in zip(lo, hi)) != len(held):
        raise AssertionError(f"{pspec}: held members {idx} are no box")
    local = torch.stack([t for _, t in held]).reshape(
        *[h - l for l, h in zip(lo, hi)], *held[0][1].shape)
    offset = [int(i) for i in torch.unravel_index(
        local.flatten()[0].long(), full.shape)]
    window = full[tuple(slice(o, o + n) for o, n
                        in zip(offset, local.shape))]
    if not torch.equal(local, window):
        raise AssertionError(f"{pspec}: the held members are not one slice")
    return {"pspec": pspec, "shape": list(full.shape),
            "local": list(local.shape), "offset": offset}


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
    elif argv[0] == "staged":
        torch_staged(argv[1])
    else:
        import torch.multiprocessing as mp

        mp.spawn(torch_rank, args=(argv[1], argv[2]), nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1:])
