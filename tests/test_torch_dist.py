"""The port's sharding layer and the plan's mesh passes against the JAX
package's, on the CPU.

The rule tables, the PartitionSpec resolution (``logical_to_pspec``,
``fit_pspec``, ``spec_to_pspec``) and every family's ``param_specs`` must
equal the reference's, string for string, on every mode and on the debug
and production axis sizes (duck-typed meshes: no devices). The plan's
ResolveMesh, ResolveSharding and PlaceStages entries and its
``describe()`` mesh keys must equal the reference's for every id. The
DTensor placements are held to JAX's own layout: every rank of 8 gloo
ranks must hold exactly the slice ``devices_indices_map`` gives device r
(each side in a subprocess of its own, with a hard timeout). Draws are
seeded numpy, never hypothesis.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.dist import sharding as jsh
from repro.models.base import build_model as jax_build_model
from repro.plan import MeshSpec as JaxMeshSpec
from repro.plan import build_plan as jax_build_plan
from repro_torch.configs import PORTED_IDS, get_config, reduced_config
from repro_torch.dist import sharding as tsh
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models.base import build_model
from repro_torch.plan import MeshSpec, build_plan

ROOT = Path(__file__).resolve().parents[1]
LAYOUT = ROOT / "tests" / "_torch_dist_layout.py"
SUBPROCESS_TIMEOUT_S = 120
DRAWS = 100
MESH_PASSES = ("ResolveMesh", "ResolveSharding", "PlaceStages")


class DuckMesh:
    """What both packages read of a mesh: axis names and a devices array."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.arange(math.prod(shape)).reshape(shape)


MESHES = {
    "debug1x1": ((1, 1), ("data", "model")),
    "debug2x4": ((2, 4), ("data", "model")),
    "debug4x2": ((4, 2), ("data", "model")),
    "prod16x16": ((16, 16), ("data", "model")),
    "prod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


# ---------------------------------------------------------------------------
# rule tables and resolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", jsh.MODES)
def test_rule_tables_equal_reference(mode):
    got = tsh.rules_for_mode(mode)
    want = jsh.rules_for_mode(mode)
    assert tsh.MODES == jsh.MODES
    assert got.mode == want.mode
    assert dict(got.items()) == dict(want.items())
    assert list(got.items()) == list(want.items())
    over = got.replace(layers="data")
    assert dict(over.items()) == dict(want.replace(layers="data").items())


def test_unknown_mode_raises_in_both():
    with pytest.raises(ValueError, match="unknown sharding mode"):
        jsh.rules_for_mode("zigzag")
    with pytest.raises(ValueError, match="unknown sharding mode"):
        tsh.rules_for_mode("zigzag")


def test_partition_spec_prints_as_jax():
    from jax.sharding import PartitionSpec as JP

    cases = [(), (None,), ("model", None), (("pod", "data"), None, "model"),
             (("data",),), ((),), (["pod", "data"], "model")]
    for entries in cases:
        got, want = tsh.PartitionSpec(*entries), JP(*entries)
        assert str(got) == str(want) and repr(got) == repr(want)
        assert tuple(got) == tuple(want)
        assert tsh.PartitionSpec.from_str(str(got)) == got
    with pytest.raises(ValueError, match="ParamSpec rank mismatch"):
        tsh.ParamSpec((2, 3), ("fsdp",))


_NAMES = sorted({k for m in jsh.MODES for k, _ in jsh.rules_for_mode(m).items()}
                | {"cascade_in", "cascade_out"}) + [None, "no_such_axis"]
_RAW = [None, "pod", "data", "model", "no_such_axis", ("pod", "data"),
        ("data", "pod"), ("data", "model"), ("pod", "data", "model"),
        ("model",), ()]


def _draw(rng):
    """A shape of rank 1-4 whose dims are products of 1, 2, 3 and 16, its
    logical names (repeats likely), and a raw PartitionSpec to fit."""
    rank = int(rng.integers(1, 5))
    shape = tuple(int(2 ** rng.integers(0, 3) * 3 ** rng.integers(0, 2)
                      * 16 ** rng.integers(0, 3)) for _ in range(rank))
    names = [_NAMES[i] for i in rng.integers(0, len(_NAMES), rank)]
    if rank > 1 and rng.random() < 0.3:
        names[1] = names[0]
    raw = [_RAW[i] for i in rng.integers(0, len(_RAW),
                                         int(rng.integers(0, rank + 2)))]
    return shape, tuple(names), raw


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", jsh.MODES)
def test_resolution_equals_reference(mode, mesh):
    from jax.sharding import PartitionSpec as JP

    duck = DuckMesh(*MESHES[mesh])
    sizes = dict(zip(duck.axis_names, duck.devices.shape))
    assert tsh.mesh_axis_sizes(duck) == sizes
    trules, jrules = tsh.rules_for_mode(mode), jsh.rules_for_mode(mode)
    rng = np.random.default_rng(sum(map(ord, mode + mesh)))
    for _ in range(DRAWS):
        shape, names, raw = _draw(rng)
        case = (shape, names, raw)
        assert str(tsh.logical_to_pspec(names, duck, trules)) == str(
            jsh.logical_to_pspec(names, duck, jrules)), case
        assert str(tsh.fit_pspec(shape, tsh.PartitionSpec(*raw), duck)) == \
            str(jsh.fit_pspec(shape, JP(*raw), duck)), case
        want = str(jsh.spec_to_pspec(jsh.ParamSpec(shape, names), duck,
                                     jrules))
        spec = tsh.ParamSpec(shape, names)
        assert str(tsh.spec_to_pspec(spec, duck, trules)) == want, case
        # the plan resolves from the axis sizes alone
        assert str(tsh.spec_to_pspec(spec, sizes, trules)) == want, case


# ---------------------------------------------------------------------------
# every family's ParamSpecs
# ---------------------------------------------------------------------------


def _jax_specs(cfg):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        jax_build_model(cfg).param_specs(),
        is_leaf=lambda x: isinstance(x, jsh.ParamSpec))
    return {jax.tree_util.keystr(p): s for p, s in leaves}


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", PORTED_IDS)
def test_param_specs_equal_reference(arch, size):
    """Keys, stacked shapes, logical axes (zamba2's doubly stacked
    ``('layers', 'layers', ...)``, the replicated kv output dim, the MoE
    experts, the vision LM's cross blocks, RWKV's mixes, the
    encoder-decoder's biases), dtype, initialiser and scale, leaf by leaf,
    in every mode; the port's model lives on the meta device."""
    for mode in jsh.MODES:
        tcfg = (get_config(arch) if size == "full"
                else reduced_config(arch)).with_(sharding_mode=mode)
        jcfg = (jax_get_config(arch) if size == "full"
                else jax_reduced_config(arch)).with_(sharding_mode=mode)
        got = build_model(tcfg, device="meta").param_specs()
        want = _jax_specs(jcfg)
        assert set(got) == set(want), set(got) ^ set(want)
        for key, w in want.items():
            g = got[key]
            assert (g.shape, g.logical, g.init, g.scale) == (
                tuple(w.shape), w.logical, w.init, w.scale), (mode, key)
            assert str(g.dtype) == f"torch.{np.dtype(w.dtype).name}", key


# ---------------------------------------------------------------------------
# the plan's mesh passes
# ---------------------------------------------------------------------------


def _mesh_view(plan):
    d = plan.describe()
    keys = ("mesh", "mesh_axes", "params", "stages", "stage_axis",
            "pipeline_stages")
    return ({k: d[k] for k in keys},
            [p for p in d["passes"] if p["pass"] in MESH_PASSES])


_PLAN_CASES = [(m, s) for m in ("debug1x1", "debug2x4", "prod16x16",
                                "prod2x16x16") for s in (1, 2)]
_PLAN_CASES.append(("prod16x16", 4))


@pytest.mark.parametrize("mode", jsh.MODES)
@pytest.mark.parametrize("arch", PORTED_IDS)
def test_plan_mesh_passes_equal_reference(arch, mode):
    """Every mesh x stages case of one id and mode: describe()'s mesh keys
    and the three mesh passes' entries (fallback wording, Eq. 2 cost,
    slices, the re-resolved ``layers -> data`` specs) string for string.
    kimi's 61 layers, mistral's 88 and zamba2's 9 groups do not divide
    over 16 rows; yi-6b's 32 do."""
    placed = 0
    for mesh, stages in _PLAN_CASES:
        duck = DuckMesh(*MESHES[mesh])
        want = jax_build_plan(arch, mode=mode, pipeline_stages=stages,
                              mesh_spec=JaxMeshSpec.from_mesh(duck))
        got = build_plan(arch, mode=mode, pipeline_stages=stages,
                         mesh_spec=MeshSpec.from_mesh(duck), device="cpu")
        assert _mesh_view(got) == _mesh_view(want), (mesh, stages)
        assert got.ir.pass_names()[1:] == want.ir.pass_names()
        placed += bool(got.ir.stages)
    if arch == "yi_6b":
        assert placed == 4      # 2 stages on 2x4, 16x16 and 2x16x16; 4 on 16x16


def test_plan_defaults_to_one_by_one_debug_mesh():
    plan = build_plan("yi-6b", debug=True, device="cpu")
    d = plan.describe()
    assert d["mesh"] == "debug:1x1" and d["mesh_axes"] == {"data": 1,
                                                          "model": 1}
    assert plan.ir.mesh is None          # no DeviceMesh until a placement
    assert plan.ir.pass_names() == ["ResolveDevice", "ResolveMesh",
                                    "ResolveSharding", "PlaceStages",
                                    "Quantize", "Compile"]
    key = plan._key("decode", 2, 16)
    assert key.mesh_axes == (("data", 1), ("model", 1)) and key.stages == 1


# ---------------------------------------------------------------------------
# DTensor layout across 8 gloo ranks, held to JAX's devices_indices_map
# ---------------------------------------------------------------------------


def test_dtensor_layout_equals_jax_on_8_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OMP_NUM_THREADS="1")
    jax_out = tmp_path / "jax.json"
    subprocess.run([sys.executable, str(LAYOUT), "jax", str(jax_out)],
                   env=env, check=True, timeout=SUBPROCESS_TIMEOUT_S)
    subprocess.run([sys.executable, str(LAYOUT), "torch",
                    str(tmp_path / "rendezvous"), str(tmp_path)],
                   env=env, check=True, timeout=SUBPROCESS_TIMEOUT_S)
    want = json.loads(jax_out.read_text())
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(8)]
    composite = 0
    for key, rec in want.items():
        composite += "('pod', 'data')" in rec["pspec"]
        for r, got in enumerate(ranks):
            window = rec["slices"][str(r)]
            assert got[key] == {"pspec": rec["pspec"],
                                "local": [b - a for a, b in window],
                                "offset": [a for a, _ in window]}, (key, r)
    assert len(want) == len(ranks[0]) and composite > 0


# ---------------------------------------------------------------------------
# meshes and shard_params on the CPU
# ---------------------------------------------------------------------------


def test_debug_mesh_builds_on_cpu():
    mesh = make_debug_mesh(1, 1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    assert dist.get_world_size() == 1
    again = make_debug_mesh(1, 1, device="cpu")     # one group per process
    assert again == mesh


@pytest.mark.parametrize("build, spec, want", [
    (lambda: make_debug_mesh(2, 4, device="cpu"), MeshSpec.debug(2, 4),
     "need 8 devices, have 1"),
    (lambda: make_production_mesh(device="cpu"), MeshSpec.production(),
     "need 256 devices, have 1"),
    (lambda: make_production_mesh(multi_pod=True, device="cpu"),
     MeshSpec.production(multi_pod=True), "need 512 devices, have 1"),
], ids=["debug2x4", "production", "multi_pod"])
def test_mesh_larger_than_world_raises(build, spec, want):
    """A mesh is never shrunk to fit (the reference's
    ``test_production_mesh_shapes``, at a world of one), and the plan's
    ResolveMesh checks the world before anything is built."""
    with pytest.raises(RuntimeError, match=want):
        build()
    with pytest.raises(RuntimeError, match=want):
        build_plan("yi-6b", debug=True, device="cpu", mesh_spec=spec)


@pytest.mark.parametrize("mode", jsh.MODES)
def test_shard_params_on_a_one_by_one_gloo_mesh(mode):
    plan = build_plan("yi-6b", debug=True, device="cpu", mode=mode)
    model = build_model(plan.cfg, device="cpu").init_params(0)
    placed = plan.shard_params(model)
    params = dict(model.named_parameters())
    assert set(placed) == set(params)
    for name, t in placed.items():
        assert torch.equal(t.to_local(), params[name]), name
        assert t.device_mesh is plan.mesh
    leaf = plan.param_placements()
    assert set(leaf) == set(plan.describe()["params"])
    # a stacked member's placements drop the stacked dim
    wq = placed["blocks.0.attn.wq.w"].placements
    full = leaf["['blocks']['attn']['wq']['w']"]
    assert [getattr(p, "dim", None) for p in wq] == [
        getattr(p, "dim", 0) - 1 if hasattr(p, "dim") else None
        for p in full]


def test_shard_params_needs_a_device_mesh():
    plan = build_plan("yi-6b", debug=True, device="cpu",
                      mesh_spec=DuckMesh((1, 1), ("data", "model")))
    model = build_model(plan.cfg, device="cpu").init_params(0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        plan.shard_params(model)


# ---------------------------------------------------------------------------
# running sharded: state specs, activation constraints, a 1x1 mesh
# ---------------------------------------------------------------------------

STATE_GEOMETRY = (2, 64)            # (batch, max_len) of the state specs
PAGES = (12, 16)                    # (page_count, page_size)


def _spec_view(specs):
    return {k: (tuple(s.shape), tuple(s.logical),
                str(np.dtype(s.dtype).name) if not isinstance(
                    s.dtype, torch.dtype) else str(s.dtype)[6:])
            for k, s in specs.items()}


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", PORTED_IDS)
def test_state_specs_equal_reference(arch, size):
    """``decode_state_specs``, ``paged_state_specs`` of it and
    ``spec_state_specs`` of it equal the reference's: keys, shapes (the
    hybrid's and the vision LM's doubly stacked leaves as the reference
    stacks them), logical axes and dtypes; full sizes on the meta
    device."""
    from repro.models import base as jbase

    from repro_torch.models import base as tbase

    tcfg = get_config(arch) if size == "full" else reduced_config(arch)
    jcfg = jax_get_config(arch) if size == "full" else jax_reduced_config(arch)
    tm, jm = build_model(tcfg, device="meta"), jax_build_model(jcfg)
    got, want = tm.decode_state_specs(*STATE_GEOMETRY), \
        jm.decode_state_specs(*STATE_GEOMETRY)
    assert _spec_view(got) == _spec_view(want)
    assert _spec_view(tbase.paged_state_specs(got, *PAGES)) == \
        _spec_view(jbase.paged_state_specs(want, *PAGES))
    assert _spec_view(tbase.spec_state_specs(got, 1)) == \
        _spec_view(jbase.spec_state_specs(want, 1))


@pytest.mark.parametrize("arch", PORTED_IDS)
def test_state_specs_lay_out_the_allocated_state(arch):
    """Every leaf ``decode_state`` allocates, dense and paged (each half),
    has a spec that ``port_layout`` maps onto its shape and dtype."""
    from repro_torch.models.base import port_layout, state_specs

    model = build_model(reduced_config(arch), device="meta")
    draft = 1 if model.cfg.family in ("dense", "moe") else 0
    for paged, only in ((None, None), (PAGES, "pool"), (PAGES, "dense")):
        state = model.decode_state(*STATE_GEOMETRY, paged=paged, only=only,
                                   draft_layers=draft)
        specs = state_specs(model, *STATE_GEOMETRY, paged=paged, only=only,
                            draft_layers=draft)
        assert set(specs) == set(state), (paged, only)
        for k, leaf in state.items():
            spec = port_layout(specs[k], tuple(leaf.shape))
            assert spec.dtype == leaf.dtype, (k, spec.dtype, leaf.dtype)


def test_shard_act_is_the_identity_outside_a_context():
    x = torch.randn(2, 3, 4)
    assert tsh.current_ctx() is None
    assert tsh.shard_act(x, "batch", "seq", "act_embed") is x
    with tsh.sharding_ctx("mesh", "rules") as ctx:
        assert tsh.current_ctx() == ctx == ("mesh", "rules")
        with tsh.sharding_ctx("inner", "rules"):
            assert tsh.current_ctx() == ("inner", "rules")
        assert tsh.current_ctx() == ("mesh", "rules")
    assert tsh.current_ctx() is None
    assert tsh.serving_grad_mode().__class__ is torch.inference_mode


# The reference's and the port's modules that call ``shard_act``.
_JAX_SITES = ("repro.layers.attention", "repro.layers.embedding",
              "repro.layers.mlp", "repro.layers.moe", "repro.layers.rwkv",
              "repro.layers.ssm", "repro.models.blocks",
              "repro.models.encdec", "repro.models.hybrid",
              "repro.models.lm", "repro.models.rwkv_model",
              "repro.models.vision_lm")
_TORCH_SITES = tuple(m.replace("repro.", "repro_torch.", 1)
                     for m in _JAX_SITES) + ("repro_torch.models.base",)


def _record_sites(monkeypatch, modules):
    import importlib

    seen = set()

    def record(x, *axes):
        seen.add((axes, tuple(int(n) for n in x.shape)))
        return x

    for name in modules:
        monkeypatch.setattr(importlib.import_module(name), "shard_act",
                            record)
    return seen


def _site_inputs(cfg, B=2, S=8):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, 2 * S, cfg.d_model))
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model))
    return batch


@pytest.mark.parametrize("arch", PORTED_IDS)
def test_shard_act_sites_equal_reference(arch, monkeypatch):
    """Every ``shard_act`` of the reference's ``forward`` and one
    ``decode_step`` has its counterpart in the port with the same logical
    axes on the same shape, and the port adds none there (its one extra
    constraint, the loss's logits before the gold gather, is not on these
    paths). The reference traces a scanned body once while the port loops
    per layer, so the distinct (axes, shape) pairs are compared."""
    import jax.numpy as jnp

    from repro.dist.sharding import init_params

    jcfg, tcfg = jax_reduced_config(arch), reduced_config(arch)
    batch = _site_inputs(tcfg)
    B = batch["tokens"].shape[0]
    want = _record_sites(monkeypatch, _JAX_SITES)
    jm = jax_build_model(jcfg)
    params = init_params(jax.random.PRNGKey(0), jm.param_specs())
    jm.forward(params, {k: jnp.asarray(v, jnp.bfloat16 if v.dtype.kind ==
                                       "f" else v.dtype)
                        for k, v in batch.items()})
    state = init_params(jax.random.PRNGKey(0), jm.decode_state_specs(B, 16))
    jm.decode_step(params, state, jnp.asarray(batch["tokens"][:, 0]),
                   jnp.int32(3))
    got = _record_sites(monkeypatch, _TORCH_SITES)
    tm = build_model(tcfg, device="cpu").init_params(0)
    tm.forward({k: torch.as_tensor(v, dtype=torch.bfloat16 if v.dtype.kind
                                   == "f" else None)
                for k, v in batch.items()})
    tm.decode_step(tm.decode_state(B, 16),
                   torch.as_tensor(batch["tokens"][:, 0]), 3)
    assert got == want, (sorted(got - want), sorted(want - got))


@pytest.mark.parametrize("mode", jsh.MODES)
def test_sharded_model_on_a_one_by_one_gloo_mesh(mode):
    """The card's set-up on the CPU: the reduced yi-6b's DTensor
    parameters on the world-1 1x1 mesh run ``forward`` and four quantized
    ``decode_step``s under ``plan.activate()`` bit for bit as the plain
    model does (every shard is whole), the state placed by its specs;
    ``unshard_model`` restores the plain parameters."""
    from torch.distributed.tensor import DTensor

    plan = build_plan("yi-6b", debug=True, device="cpu", mode=mode,
                      quantized=True)
    model = plan.init_params(0)
    assert not plan.sharded
    plain = {n: p for n, p in model.named_parameters()}
    tokens = torch.arange(16, dtype=torch.int32).view(2, 8)
    ref = model.forward({"tokens": tokens})
    state = plan.fresh_decode_state(2, 16)
    ref_dec = [model.decode_step(state, tokens[:, i], i)[0]
               for i in range(4)]
    plan.shard_model(model)
    assert plan.sharded
    assert all(isinstance(p, DTensor) for p in model.parameters())
    with plan.activate():
        got = model.forward({"tokens": tokens})
        assert isinstance(got, DTensor)
        assert torch.equal(got.full_tensor(), ref)
        state = plan.fresh_decode_state(2, 16)
        assert all(isinstance(v, DTensor) for v in state.values())
        for i in range(4):
            logits, _ = model.decode_step(state, tokens[:, i], i)
            assert torch.equal(logits.full_tensor(), ref_dec[i]), i
    plan.unshard_model(model)
    assert not plan.sharded
    for n, p in model.named_parameters():
        assert type(p.data) is torch.Tensor and torch.equal(p, plain[n]), n


def test_kernel_wrappers_refuse_a_mixed_call():
    """A kernel wrapper given DTensors gathers them and runs once (the
    plain version on the CPU), returning a replicated DTensor; a call that
    mixes a DTensor and a plain tensor raises."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.qmatmul.ops import qlinear

    mesh = make_debug_mesh(1, 1, device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-100, 100, (4, 64), generator=g, dtype=torch.int8)
    w = torch.randint(-100, 100, (64, 32), generator=g, dtype=torch.int8)
    xd = DTensor.from_local(x, mesh, [Shard(0), Replicate()])
    wd = DTensor.from_local(w, mesh, [Replicate(), Shard(1)])
    y = qlinear(xd, wd, shift=7)
    assert isinstance(y, DTensor) and all(
        p == Replicate() for p in y.placements)
    assert torch.equal(y.to_local(), qlinear(x, w, shift=7))
    with pytest.raises(TypeError, match="mixes DTensors and plain"):
        qlinear(xd, w, shift=7)
    q = torch.randn(2, 8, 16, generator=g)
    qd = DTensor.from_local(q, mesh, [Shard(0), Replicate()])
    o = flash_attention(qd, qd, qd)
    assert torch.equal(o.to_local(), flash_attention(q, q, q))
    with pytest.raises(TypeError, match="mixes DTensors and plain"):
        flash_attention(qd, q, q)


def test_local_product_keeps_rows_or_columns_and_gathers_the_rest():
    """A product DTensor has no rule for runs on local operands: rows of
    ``a`` or columns of ``b`` stay sharded, the contraction is whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = make_debug_mesh(1, 1, device="cpu")
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(4, 6, generator=g), torch.randn(6, 8, generator=g)
    cases = [([Shard(0), Shard(1)], [Shard(0), Shard(1)],
              (Shard(0), Shard(1))),
             ([Replicate(), Shard(1)], [Shard(0), Replicate()],
              (Replicate(), Replicate()))]
    for pa, pb, want in cases:
        y = tsh.local_product(torch.mm, DTensor.from_local(a, mesh, pa),
                              DTensor.from_local(b, mesh, pb))
        assert tuple(y.placements) == want
        assert torch.equal(y.full_tensor(), a @ b)
    e = torch.randn(2, 4, 6, generator=g)
    w = torch.randn(2, 6, 3, generator=g)
    y = tsh.local_product(torch.bmm,
                          DTensor.from_local(e, mesh, [Shard(0), Shard(2)]),
                          DTensor.from_local(w, mesh, [Shard(0), Shard(1)]))
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert torch.equal(y.full_tensor(), torch.bmm(e, w))


def test_async_server_enters_the_sharded_context_on_its_worker():
    """The async server's worker thread enters the plan's sharding context
    itself (the context is thread-local): continuous paged streams of the
    reduced yi-6b sharded on the 1x1 gloo mesh equal the plain model's."""
    import asyncio

    from repro_torch.serve import (
        AsyncServeServer,
        Bucket,
        BucketPolicy,
        DecodeRequest,
    )

    trace = [(f"a{i}", [3 + i, 7, 11], 5) for i in range(3)]

    def serve(shard):
        plan = build_plan("yi-6b", debug=True, device="cpu",
                          mode="megatron_sp")
        plan.init_params(0, shard=shard)
        assert plan.sharded == shard
        b = plan.make_batcher(policy=BucketPolicy([Bucket(64, 2)]),
                              schedule="continuous", steps_per_dispatch=4,
                              paged=(16, 16))

        async def drive():
            async with AsyncServeServer(b) as server:
                got = await asyncio.gather(*[
                    server.generate(DecodeRequest(r, p, max_new_tokens=n))
                    for r, p, n in trace])
                return {g.request_id: g.tokens for g in got}, server.stats()

        return asyncio.run(drive())

    plain, _ = serve(False)
    got, stats = serve(True)
    assert got == plain
    assert stats["outcomes"] == {"done": len(trace)}
