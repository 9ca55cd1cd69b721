"""``build_plan`` and :class:`ExecutionPlan`: the one execution API of the
port.

    from repro_torch.plan import build_plan
    plan = build_plan("yi-6b", shape=ShapeSpec("p", 2048, 2, "prefill"))
    model = plan.init_params(seed=0)       # random weights on the card
    prefill = plan.executable("prefill")   # bound step, cached, counted
    logits = prefill.fn(plan.model, {"tokens": tokens})

    plan = build_plan("yi-6b", shape=ShapeSpec("t", 2048, 2, "train"))
    model, opt_state = plan.init_train_state(seed=0)
    metrics = plan.executable("train").fn(model, opt_state, batch)

The plan owns the model (its parameters), the quantization decisions and
every step function; the serving batcher is a thin consumer. It also
decides where each parameter lives on a device mesh (``mesh_spec``: the
rule table of ``mode``, each leaf's PartitionSpec, the pipeline stages),
and places parameters there as DTensors on request:

    plan = build_plan("yi-6b", mode="megatron", device="cpu")
    plan.describe()["params"]              # {leaf key: PartitionSpec text}
    plan.param_placements()                # {leaf key: DTensor placements}
    plan.shard_params(model)               # {parameter name: DTensor}

and runs sharded over them, one stage (every rank of the mesh runs the
whole stack, as the reference's GSPMD program does):

    model = plan.init_params(seed=0, shard=True)   # DTensor parameters
    with plan.activate():                  # shard_act lays activations out
        logits = model.forward({"tokens": tokens})
        state = plan.fresh_decode_state(8, 64)     # placed by its specs

and trains sharded, the optimizer state placed by its ``state_specs``:

    model, opt_state = plan.init_train_state(seed=0)   # placed when sharded
    Trainer(model_loss, plan.optimizer, cfg, mesh=plan.mesh,
            rules=plan.rules).fit(model, opt_state, stream)

A staged plan (``pipeline_stages`` > 1 with ``layers -> data``) places
each member of a stacked leaf on the data row that owns it and gathers a
block's members only while the block runs (``repro_torch.dist.staging``).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core.emit import DeviceLike
from repro_torch.dist.sharding import (
    ParamSpec,
    PartitionSpec,
    local_value,
    pspec_to_placements,
    serving_grad_mode,
    shard_act,
    sharded,
    spec_to_pspec,
)
from repro_torch.launch.steps import (
    make_masked_decode_step,
    make_prefill_decode_step,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.models.base import (
    SHAPES,
    ArchConfig,
    ShapeSpec,
    build_model,
    port_layout,
    state_specs,
)
from repro_torch.plan.ir import MeshSpec, PlanIR
from repro_torch.plan.passes import (
    PLAN_PIPELINE,
    calibrate_mlp_shifts,
    param_specs,
)
from repro_torch.serve.cache import CachedExecutable, CacheKey, ExecutableCache


class ExecutionPlan:
    """A resolved execution recipe: device + mesh + rules + stages +
    quantization + the step catalogue. Construct via :func:`build_plan`."""

    def __init__(self, ir: PlanIR, cache: Optional[ExecutableCache] = None):
        self.ir = ir
        self.cache = cache or ExecutableCache()
        self._model = None
        self._optimizer = None
        self._built_any = False
        self.sharded = False

    # -- resolved views -------------------------------------------------------

    @property
    def cfg(self) -> ArchConfig:
        return self.ir.cfg

    @property
    def device(self) -> torch.device:
        return self.ir.device

    @property
    def mesh(self):
        """The plan's mesh, built on first use: a ``DeviceMesh`` of the
        plan's device type (starting the process group it needs), or the
        mesh an explicit ``MeshSpec`` wraps."""
        if self.ir.mesh is None:
            self.ir.mesh = self.ir.mesh_spec.build(device=self.device)
        return self.ir.mesh

    @property
    def rules(self):
        return self.ir.rules

    @property
    def mode(self) -> str:
        return self.ir.mode

    @property
    def shape(self) -> Optional[ShapeSpec]:
        return self.ir.shape

    @property
    def model(self):
        """The loaded model (``init_params`` or ``load_params`` first)."""
        if self._model is None:
            raise RuntimeError("no parameters loaded (init_params / "
                               "load_params)")
        return self._model

    @property
    def optimizer(self):
        """The config's optimizer (``cfg.optimizer``: adamw or adafactor),
        made once."""
        if self._optimizer is None:
            from repro_torch.optim.optimizers import make_optimizer

            self._optimizer = make_optimizer(self.cfg.optimizer)
        return self._optimizer

    @contextmanager
    def activate(self):
        """Run sharded: ``sharding_ctx(mesh, rules)`` for this thread, so
        every ``shard_act`` lays its activation out on the plan's mesh, and
        DTensor's implicit replication, so the plain tensors the layers
        make (positions, masks, RoPE tables, a step's token lanes) meet
        DTensors as replicated ones (the counterpart of the reference's
        ``with mesh, sharding_ctx(...)``). The replication switch is
        process-wide, so a backward must run inside the context too."""
        with sharded(self.mesh, self.rules):
            yield self

    @staticmethod
    def serving_grad_mode():
        """The autograd mode of the serve path, decided at the call
        (``dist.sharding.serving_grad_mode``): ``torch.inference_mode()``
        on one device, ``torch.no_grad()`` inside the plan's sharding
        context (:meth:`activate`). The batcher drains its queue under
        it."""
        return serving_grad_mode()

    @staticmethod
    def place_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """A step's input batch laid out over the data axes inside
        :meth:`activate` (``shard_act(x, "batch")`` per input, as the
        train step lays out its batch and as the reference's compiled
        steps take their inputs' shardings from the plan); outside a
        sharding context each tensor as it is."""
        return {name: shard_act(x, "batch") for name, x in batch.items()}

    # -- parameters / placement ----------------------------------------------

    def param_specs(self):
        """``{leaf key: ParamSpec}`` of the plan's model (built on the
        ``meta`` device)."""
        return dict(param_specs(self.cfg))

    def param_placements(self) -> Dict[str, list]:
        """``{leaf key: DTensor placements}`` on :attr:`mesh`, one per mesh
        dim, from the PartitionSpecs the plan recorded."""
        mesh = self.mesh
        return {key: pspec_to_placements(PartitionSpec.from_str(text), mesh)
                for key, text in self.ir.param_pspecs.items()}

    def iter_shard_params(self, model=None):
        """Yield ``(parameter name, DTensor)`` for every parameter of
        ``model`` (default: the plan's), one at a time, each placed on
        :attr:`mesh` from its whole value on every rank (no data moves). A
        member of a stacked leaf takes the leaf's placements with the
        stacked dims dropped; a member of a staged leaf (``layers -> data``
        after PlaceStages) lives on its band, the data row that owns it,
        and takes no memory on any other rank (``dist.staging``)."""
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.bridge import leaf_groups
        from repro_torch.dist.staging import place_member
        from repro_torch.models.base import leaf_key

        model = self.model if model is None else model
        mesh = self.mesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"shard_params needs a torch DeviceMesh, the "
                            f"plan's mesh is {type(mesh).__name__}")
        if model.device.type not in (mesh.device_type, "meta"):
            raise ValueError(f"model on {model.device}, mesh on "
                             f"{mesh.device_type}")
        placements = self.param_placements()
        params = dict(model.named_parameters())
        for grp in leaf_groups(model):
            leaf = placements[leaf_key(grp.name)]
            for index, name in enumerate(grp.members):
                yield name, place_member(params.pop(name).detach(), mesh,
                                         leaf, grp.stack, index)

    def shard_params(self, model=None) -> Dict[str, Any]:
        """``{parameter name: DTensor}``: :meth:`iter_shard_params` at once."""
        return dict(self.iter_shard_params(model))

    def shard_model(self, model=None):
        """Install the sharded parameters into ``model`` (default: the
        plan's): each parameter is replaced by its DTensor from
        :meth:`iter_shard_params`, one at a time, so the plain tensor is
        freed (unless the caller holds it) before the next is placed, and
        the peak grows by at most one parameter. The int8 weight copies are
        dropped and remade from the DTensors. Steps then run sharded under
        :meth:`activate`. Returns the model."""
        from torch import nn

        from repro_torch.dist.staging import mark_staged

        model = self.model if model is None else model
        for name, dt in self.iter_shard_params(model):
            parent, leaf = name.rsplit(".", 1)
            setattr(model.get_submodule(parent), leaf,
                    nn.Parameter(dt, requires_grad=False))
        mark_staged(model)
        model.reset_quantized()
        self.sharded = True
        return model

    def unshard_model(self, model=None):
        """The inverse of :meth:`shard_model`: each DTensor parameter is
        replaced by its whole value as a plain tensor on this rank
        (gathered, one parameter at a time). Returns the model."""
        from torch import nn

        from repro_torch.dist.staging import mark_staged

        model = self.model if model is None else model
        for name, p in list(model.named_parameters()):
            parent, leaf = name.rsplit(".", 1)
            setattr(model.get_submodule(parent), leaf,
                    nn.Parameter(local_value(p.detach()),
                                 requires_grad=False))
        mark_staged(model)
        model.reset_quantized()
        self.sharded = False
        return model

    # -- parameters / state ---------------------------------------------------

    def init_params(self, seed: int = 0, shard: Optional[bool] = None):
        """Random parameters on the plan's device (demos, benchmarks,
        tests); calibrates the quantization shifts. With ``shard`` (by
        default when the mesh has more than one device) the parameters
        are then placed on the mesh (:meth:`shard_model`). Returns the
        model."""
        model = build_model(self.cfg, device=self.device).init_params(seed)
        return self._install(model, shard)

    def init_train_state(self, seed: int = 0, shard: Optional[bool] = None):
        """``(model, optimizer state)`` ready for the train step: random
        parameters (:meth:`init_params`, placed with ``shard``) and the
        optimizer's state over the reference's leaves
        (``bridge.leaf_groups``); on a sharded model the state is placed
        on the mesh by the optimizer's ``state_specs``
        (:meth:`placed_opt_state`), as the reference's ``init`` runs under
        its mesh."""
        from repro_torch.bridge import leaf_groups

        model = self.init_params(seed, shard=shard)
        if self.sharded:
            return model, self.placed_opt_state(model)
        opt_state = self.optimizer.init(dict(model.named_parameters()),
                                        leaf_groups(model))
        return model, opt_state

    def opt_state_specs(self, model=None) -> Dict[str, Any]:
        """The optimizer's ``state_specs`` over the model's leaves, keyed
        as its state is (by leaf name, ``blocks.attn.wq.w``)."""
        from repro_torch.bridge import leaf_groups
        from repro_torch.models.base import leaf_key

        model = self.model if model is None else model
        specs = model.param_specs()
        return self.optimizer.state_specs(
            {g.name: specs[leaf_key(g.name)] for g in leaf_groups(model)})

    def spec_placements(self, specs):
        """The DTensor placements on :attr:`mesh` of every ``ParamSpec`` of
        a (nested) dict of them, under the plan's rules."""
        mesh = self.mesh
        if isinstance(specs, ParamSpec):
            return pspec_to_placements(spec_to_pspec(specs, mesh,
                                                     self.rules), mesh)
        return {k: self.spec_placements(v) for k, v in specs.items()}

    def placed_opt_state(self, model=None) -> Dict[str, Any]:
        """The optimizer's initial state for a sharded model, each leaf a
        DTensor at the placements of its spec (:meth:`opt_state_specs`).
        Both optimizers start every leaf at zero, so each rank allocates
        only its shard (none on a ``meta`` model: the dry run); the
        structure is checked against the optimizer's own ``init`` (run on
        the meta device)."""
        from torch.distributed.tensor import zeros as dtensor_zeros

        from repro_torch.bridge import leaf_groups
        from repro_torch.dist.sharding import meta_placed

        model = self.model if model is None else model
        specs = self.opt_state_specs(model)
        meta = self.optimizer.init(
            {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
             for n, p in model.named_parameters()}, leaf_groups(model))
        mesh = self.mesh

        def build(spec, like, path):
            if isinstance(spec, ParamSpec):
                if (tuple(like.shape), like.dtype) != (spec.shape,
                                                       spec.dtype) \
                        or spec.init != "zeros":
                    raise ValueError(f"{path}: state {tuple(like.shape)} "
                                     f"{like.dtype} != spec {spec}")
                placements = self.spec_placements(spec)
                if model.device.type == "meta":
                    return meta_placed(spec.shape, spec.dtype, mesh,
                                       placements)
                return dtensor_zeros(
                    spec.shape, dtype=spec.dtype, device_mesh=mesh,
                    placements=placements)
            if set(spec) != set(like):
                raise KeyError(f"{path}: state keys {sorted(like)} != "
                               f"specs {sorted(spec)}")
            return {k: build(spec[k], like[k], f"{path}/{k}") for k in spec}

        return build(specs, meta, "opt")

    def train_state_shardings(self, model=None, compress: bool = False
                              ) -> Dict[str, Any]:
        """``{"params", "opt", "res"}``: a ``(mesh, placements)`` for every
        leaf of the trainer's checkpoint (the stacked parameter tree, the
        optimizer state, the error-feedback residuals: each leaf's
        placements with ``compress``, else replicated scalars) on this
        plan's mesh, the ``shardings`` of ``Trainer.restore_elastic``."""
        from repro_torch.bridge import _nest, leaf_groups
        from repro_torch.models.base import leaf_key

        model = self.model if model is None else model
        mesh = self.mesh
        specs = model.param_specs()
        groups = leaf_groups(model)
        leaf = {g.name: (mesh, self.spec_placements(specs[leaf_key(g.name)]))
                for g in groups}
        opt = self.spec_placements(self.opt_state_specs(model))

        def pair(tree):
            return {k: pair(v) if isinstance(v, dict) else (mesh, v)
                    for k, v in tree.items()}

        scalar = (mesh, pspec_to_placements(PartitionSpec(), mesh))
        return {"params": _nest(leaf), "opt": pair(opt),
                "res": dict(leaf) if compress
                else {g.name: scalar for g in groups}}

    def load_params(self, params, shard: Optional[bool] = None):
        """Install a ported model (``DecoderLM``, ``HybridModel``) or the
        reference's parameter tree as numpy arrays (see
        ``repro_torch.bridge.model_from_arrays``), then calibrate, then
        place it on the mesh with ``shard`` (as :meth:`init_params`).
        Returns the model."""
        from repro_torch.models.base import PortedLM

        if not isinstance(params, PortedLM):
            from repro_torch.bridge import model_from_arrays

            params = model_from_arrays(self.cfg, params, self.device)
        if params.device != self.device:
            raise ValueError(f"model is on {params.device}, the plan on "
                             f"{self.device}")
        return self._install(params, shard)

    def _install(self, model, shard: Optional[bool] = None):
        model.cfg = self.cfg
        model.reset_quantized()
        self._model = model
        self.sharded = False
        self.calibrate()
        if shard is None:        # by default when the mesh has several
            shard = math.prod(self.ir.axes.values()) > 1
        if shard:
            self.shard_model(model)
        return model

    def fresh_decode_state(self, batch: int, max_len: int, paged=None,
                           only: Optional[str] = None, spec=None):
        """A zeroed decode state for one bucket shape.

        With ``paged=(page_count, page_size)`` the KV leaves come in the
        shared-pool layout [L, page_count, page_size, KV, hd]; ``only``
        restricts a paged build to one half: ``"pool"`` the pool leaves
        (bucket-independent: the StatePool builds them once), ``"dense"``
        the per-slot remainder. With ``spec=(spec_k, draft_layers)`` the
        state also carries the draft's ``draft_`` KV twins (pooled too
        when paged: they ride the slot's page table).

        On a sharded model every leaf is placed on the mesh by its spec
        (the reference's ``decode_state_specs``, ``paged_state_specs``
        and ``spec_state_specs``, in the port's layout): the KV caches'
        batch on the data axis and heads on the model axis, the page
        pool's page axes replicated."""
        draft_layers = spec[1] if spec is not None else 0
        state = self.model.decode_state(batch, max_len, paged=paged,
                                        only=only, draft_layers=draft_layers)
        if not self.sharded:
            return state
        return self._place_state(state, state_specs(
            self.model, batch, max_len, paged=paged, only=only,
            draft_layers=draft_layers))

    def _place_state(self, state: Dict[str, torch.Tensor],
                     specs: Dict[str, Any]) -> Dict[str, Any]:
        """``{key: DTensor}``: each leaf of ``state`` placed on the mesh by
        the PartitionSpec of its spec in ``specs`` (``models.base``'s
        reference-layout specs, laid out as the port's leaf)."""
        from repro_torch.dist.sharding import place

        if set(specs) != set(state):
            raise KeyError(f"state leaves {sorted(state)} != specs "
                           f"{sorted(specs)}")
        mesh = self.mesh
        out = {}
        for name, leaf in state.items():
            spec = port_layout(specs[name], tuple(leaf.shape))
            out[name] = place(
                leaf, mesh,
                pspec_to_placements(spec_to_pspec(spec, mesh, self.rules),
                                    mesh))
        return out

    # -- quantization calibration ---------------------------------------------

    def calibrate(self) -> "ExecutionPlan":
        """Refine the Quantize pass's MLP shifts from the loaded weights.

        Runs once, before any step is built (a calibration after a build
        would silently mismatch the cache keys of the built steps, so it
        is skipped and recorded instead).
        """
        if not self.cfg.quantized_mlp or self.ir.quant.get("calibrated"):
            return self
        if self._built_any:
            self.ir.record("Quantize", skipped_calibration=(
                "steps already built with default shifts"))
            return self
        x_s, w_s, o_s = calibrate_mlp_shifts(self.cfg, self.model)
        self.ir.cfg = self.cfg.with_(
            mlp_x_shift=x_s, mlp_w_shift=w_s, mlp_out_shift=o_s)
        self.model.cfg = self.ir.cfg
        self.ir.quant.update(mlp_shifts=(x_s, w_s, o_s), calibrated=True)
        self.ir.record("Quantize", calibrated_mlp_shifts=(x_s, w_s, o_s))
        return self

    def _qsig(self):
        cfg = self.cfg
        if not cfg.quantized_mlp:
            return ()
        return (("mlp", cfg.mlp_x_shift, cfg.mlp_w_shift, cfg.mlp_out_shift),)

    # -- executables ----------------------------------------------------------

    def _key(self, kind: str, batch: int, max_len: int,
             prefill_len: int = 0, steps: int = 1, paged=(),
             spec=(), on_mesh: bool = False) -> CacheKey:
        return CacheKey(
            arch=self.cfg.name, kind=kind, batch=batch, max_len=max_len,
            prefill_len=prefill_len, mode=self.mode,
            mesh_axes=CacheKey.mesh_signature(self.ir.axes),
            quantized=self.cfg.quantized,
            stages=self.ir.pipeline_stages, qsig=self._qsig(),
            steps=steps, paged=tuple(paged), spec=tuple(spec),
            on_mesh=on_mesh,
        )

    def executable(self, kind: Optional[str] = None) -> CachedExecutable:
        """The step for this plan's ShapeSpec ("train", "prefill" or
        "decode"), built once through the ExecutableCache and counted. The
        train step runs on the plan's mesh while the model is placed there
        (:meth:`shard_model`); being bound to the mesh is part of its key,
        so a step built before :meth:`shard_model` (or
        :meth:`unshard_model`) is not served after it."""
        shape = self.shape
        if shape is None:
            raise ValueError(
                "this plan has no pinned ShapeSpec (serve plans build "
                "per-bucket steps via serve_executable)")
        kind = kind or shape.kind
        on_mesh = kind == "train" and self.sharded
        builders = {
            "prefill": lambda: make_prefill_step(self.cfg, shape),
            "decode": lambda: make_serve_step(self.cfg, shape),
            "train": lambda: make_train_step(
                self.cfg, shape, self.optimizer,
                mesh=self.mesh if on_mesh else None, rules=self.rules),
        }
        if kind not in builders:
            raise ValueError(f"unknown executable kind {kind!r}")
        key = self._key(kind, shape.global_batch, shape.seq_len,
                        on_mesh=on_mesh)
        self._built_any = True
        return self.cache.get_or_build(key, builders[kind])

    def serve_executable(self, kind: str, *, batch: int, max_len: int,
                         prefill_len: int = 0, steps_per_dispatch: int = 1,
                         paged=None, spec=None) -> CachedExecutable:
        """A bucketed serving step: ``kind`` is "decode" (one token against
        resident state), "prefill" (the prefill->decode handoff loop over a
        prompt block padded to ``prefill_len``) or "masked_decode" (the
        slot-masked continuous-batching micro-run of ``steps_per_dispatch``
        steps; one step per (bucket, k), keyed apart in the cache).
        ``paged=(page_count, page_size)`` (masked_decode only) swaps the
        dense KV slabs for the shared page pool plus a page-table input.
        ``spec=(spec_k, draft_layers)`` (masked_decode only) builds the
        speculative micro-run (a layer-prefix draft, then a block verify;
        see ``make_masked_decode_step``); ``spec`` joins the cache key, so
        steps differing only in draft depth never share an entry."""
        if steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        if steps_per_dispatch > 1 and kind != "masked_decode":
            raise ValueError(
                "steps_per_dispatch only applies to masked_decode "
                f"executables, not {kind!r}")
        if paged is not None:
            if kind != "masked_decode":
                raise ValueError(
                    "paged KV only applies to masked_decode executables, "
                    f"not {kind!r}")
            page_count, page_size = paged
            if page_size < 1 or page_count < 1:
                raise ValueError(f"bad paged geometry {paged!r}")
            if max_len % page_size:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of page_size "
                    f"{page_size}")
        if spec is not None and kind != "masked_decode":
            raise ValueError(
                "speculative decode only applies to masked_decode "
                f"executables, not {kind!r}")
        if kind == "decode":
            shape = ShapeSpec(f"b{batch}xl{max_len}", max_len, batch,
                              "decode")
            build = lambda: make_serve_step(self.cfg, shape)  # noqa: E731
        elif kind == "prefill":
            build = lambda: make_prefill_decode_step(  # noqa: E731
                self.cfg, batch, prefill_len, max_len)
        elif kind == "masked_decode":
            build = lambda: make_masked_decode_step(  # noqa: E731
                self.cfg, batch, max_len,
                steps_per_dispatch=steps_per_dispatch, paged=paged, spec=spec)
        else:
            raise ValueError(f"unknown serve executable kind {kind!r}")
        key = self._key(kind, batch, max_len, prefill_len,
                        steps=steps_per_dispatch,
                        paged=paged if paged is not None else (),
                        spec=spec if spec is not None else ())
        self._built_any = True
        return self.cache.get_or_build(key, build)

    @staticmethod
    def token_argmax(logits: torch.Tensor) -> torch.Tensor:
        """Greedy token selection: int32 argmax over the vocab, a plain
        tensor (a sharded model's logits are gathered first)."""
        return local_value(torch.argmax(logits, dim=-1)).to(torch.int32)

    def make_batcher(self, policy=None, **kw):
        """A ServeBatcher whose steps all come from this plan."""
        from repro_torch.serve.batcher import ServeBatcher

        return ServeBatcher(self, policy=policy, **kw)

    # -- observability --------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        """JSON-able dump of every pass decision."""
        ir = self.ir
        return {
            "arch": self.cfg.name,
            "family": self.cfg.family,
            "shape": ir.shape.name if ir.shape else None,
            "mode": ir.mode,
            "device": str(ir.device),
            "mesh": ir.mesh_spec.label(),
            "mesh_axes": dict(ir.axes),
            "quantized": ir.quantized,
            "pipeline_stages": ir.pipeline_stages,
            "stage_axis": ir.stage_axis,
            "stages": [s.as_dict() for s in ir.stages],
            "quant": dict(ir.quant),
            "executables": ir.executables,
            "params": dict(ir.param_pspecs),
            "passes": [{"pass": name, **entry}
                       for name, entry in ir.decisions],
            "cache": self.cache.stats(),
        }


def build_plan(
    arch: Union[str, ArchConfig],
    shape: Union[str, ShapeSpec, None] = None,
    *,
    mode: Optional[str] = None,
    mesh_spec: Optional[Any] = None,
    quantized: bool = False,
    pipeline_stages: int = 1,
    debug: bool = False,
    config_overrides: Optional[Dict[str, Any]] = None,
    cache: Optional[ExecutableCache] = None,
    device: DeviceLike = None,
) -> ExecutionPlan:
    """Run the plan pass pipeline and return the ExecutionPlan.

    ``arch`` is an architecture alias ("yi-6b") or an ArchConfig; ``shape``
    a ShapeSpec / SHAPES name, or None for a serve plan whose shapes come
    per bucket. ``debug`` picks the reduced config. ``mode`` overrides the
    config's sharding mode. ``mesh_spec`` is a MeshSpec, a ``DeviceMesh``
    or a duck-typed mesh; it defaults to the 1x1 debug mesh, with ``debug``
    or without (a documented divergence: the reference's default without
    ``debug`` is the 256-device production mesh, and the port runs on one
    card). ``pipeline_stages`` > 1 engages the PlaceStages pass.
    ``device`` defaults to the card (and raises without one).
    """
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        from repro_torch.configs import get_config, reduced_config

        cfg = reduced_config(arch) if debug else get_config(arch)
    if config_overrides:
        cfg = cfg.with_(**config_overrides)
    if mode:
        cfg = cfg.with_(sharding_mode=mode)
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if mesh_spec is None:
        mesh_spec = MeshSpec.debug(1, 1)
    elif not isinstance(mesh_spec, MeshSpec):
        mesh_spec = MeshSpec.from_mesh(mesh_spec)
    ir = PlanIR(cfg=cfg, shape=shape, mode=cfg.sharding_mode,
                mesh_spec=mesh_spec, device_request=device,
                quantized=quantized, pipeline_stages=pipeline_stages)
    for _name, pass_fn in PLAN_PIPELINE:
        ir = pass_fn(ir)
    return ExecutionPlan(ir, cache)
