"""Training loop: checkpoint/restart, straggler monitoring, microbatch
gradient accumulation with optional int8 error-feedback compression (the
reference's ``repro.train.trainer``).

A step runs eagerly in place of the reference's jitted, donating step: the
loss and its gradients through autograd, then the optimizer writes the
parameters and its state in place. ``Trainer.fit`` is restart-safe: it
resumes from the newest checkpoint (the data pipeline is a pure function
of the step, so the token stream continues bit-identically), and the
parameters after a crash and resume equal an uninterrupted run's.

The parameters require grad only inside a step (:func:`recording`); the
serving entry points never see a grad-requiring parameter. On the card a
step also runs with ``torch.use_deterministic_algorithms`` (warn only), so
that the same step repeats bit for bit; cuBLAS honours it only with
``CUBLAS_WORKSPACE_CONFIG`` set before its first use, which the train CLI
and ``chip_smoke.py`` do. Under that mode the MoE's scatters (the
``index_add_`` combine, the backward of its gathers) run torch's
deterministic implementations instead of atomic adds, so a dense and an
MoE restart on the card are both ``torch.equal`` to an uninterrupted run,
with no determinism warning (``tests/test_torch_cuda.py``).

On a mesh (``Trainer(..., mesh=, rules=)`` over a model whose parameters
``ExecutionPlan.shard_model`` made DTensors) every step, forward and
backward, runs inside ``sharding_ctx(mesh, rules)`` with implicit
replication, as the reference's jitted step runs under its mesh: each
(micro)batch is laid out over the data axes (``shard_act`` "batch"),
each gradient is redistributed to its parameter's placements before the
clip reads it, and the optimizer updates the placed state. Checkpoints
hold the whole tensors (``CheckpointManager``); ``restore_latest`` puts
the state back at its placements and ``restore_elastic`` onto another
mesh. There is no fallback: a sharded step that fails raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

import numpy as np
import torch

from repro_torch.bridge import (
    leaf_groups,
    load_arrays,
    params_template,
    params_to_arrays,
)
from repro_torch.dist.sharding import (
    at_placements,
    is_dtensor,
    local_value,
    place,
    rules_for_mode,
    shard_act,
    sharded,
)
from repro_torch.dist.staging import owned, stacked_placements
from repro_torch.optim.compression import error_feedback_reduce
from repro_torch.optim.optimizers import (
    Optimizer,
    group_shape,
    member_rows,
    stacked,
)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import FailureInjector, StragglerMonitor

LossFn = Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]


def model_loss(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The model's own training objective (``model.loss``)."""
    return model.loss(batch)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    microbatches: int = 1            # gradient-accumulation factor
    compress_grads: bool = False     # int8 error feedback per step


@contextlib.contextmanager
def recording(tensors: List[torch.Tensor]):
    """Let autograd record through ``tensors`` (``requires_grad`` on) for
    the body, and turn it off again after. On the card, deterministic
    algorithms are on for the body too."""
    cuda = any(t.is_cuda for t in tensors)
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    for t in tensors:
        t.requires_grad_(True)
    if cuda:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        for t in tensors:
            t.requires_grad_(False)
        if cuda:
            torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def _placed(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A (micro)batch laid out over the data axes under an active
    ``sharding_ctx`` (the reference's ``batch_sharding``); as it is
    outside one."""
    return {k: shard_act(v, "batch") for k, v in batch.items()}


def value_and_grad(loss_fn: LossFn, model, batch: Dict[str, torch.Tensor],
                   microbatches: int = 1
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, grads)`` of ``loss_fn(model, batch)`` for every parameter
    of ``model``, by name.

    With one microbatch the gradients come in each parameter's dtype, as
    the reference's do. With N > 1 the batch splits into N along its first
    axis; the microbatch gradients are summed into fp32 buffers and scaled
    by 1/N (never summed through ``.grad`` in the parameter dtype), and
    the loss is the mean of the microbatch losses. A DTensor parameter's
    gradient comes at the parameter's placements (a ``Partial`` one is
    reduced onto them)."""
    params = dict(model.named_parameters())
    tensors = list(params.values())

    def grads_of(loss):
        grads = torch.autograd.grad(loss, tensors, materialize_grads=True)
        return [at_placements(g, t) for g, t in zip(grads, tensors)]

    with recording(tensors):
        if microbatches == 1:
            loss = loss_fn(model, _placed(batch))
            return loss.detach(), dict(zip(params, grads_of(loss)))
        for name, x in batch.items():
            if x.shape[0] % microbatches:
                raise ValueError(f"batch {name} of {x.shape[0]} rows does not "
                                 f"split into {microbatches} microbatches")
        acc = [torch.zeros_like(t, dtype=torch.float32) for t in tensors]
        total = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
        for i in range(microbatches):
            micro = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                  *v.shape[1:])[i] for k, v in batch.items()}
            loss = loss_fn(model, _placed(micro))
            for a, g in zip(acc, grads_of(loss)):
                a.add_(g)
            total = total + loss.detach()
            del loss
    inv = 1.0 / microbatches
    return total * inv, {name: a.mul_(inv) for name, a in zip(params, acc)}


def init_residuals(model, groups, compress: bool) -> Dict[str, torch.Tensor]:
    """The error-feedback residuals, one per reference leaf: fp32 zeros of
    the leaf's shape with compression, else an fp32 zero scalar each (the
    reference's checkpoint layout either way)."""
    params = dict(model.named_parameters())
    dev = model.device
    out = {}
    for g in groups:
        zeros = torch.zeros(group_shape(g, params) if compress else (),
                            dtype=torch.float32, device=dev)
        first = params[g.members[0]]
        if compress and is_dtensor(first):    # at the leaf's placements
            zeros = place(zeros, *stacked_placements(first, tuple(g.stack)))
        out[g.name] = zeros
    return out


@torch.no_grad()
def compress_with_feedback(grads: Dict[str, torch.Tensor], residuals,
                           groups) -> None:
    """Int8 error feedback over each reference leaf (its max-scale spans
    the stacked leaf): replaces ``grads`` by their decoded fp32 values and
    ``residuals`` by the new residuals, in place."""
    for grp in groups:
        g = stacked(grads, grp)
        reduced, residuals[grp.name] = error_feedback_reduce(
            g, residuals[grp.name])
        rows = member_rows(at_placements(reduced, g), grp)
        for i, name in enumerate(owned(grp.members, grads)):
            grads[name] = _as_member(rows[i], grads[name])


def _as_member(row: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A member's row of a stacked leaf (a plain local shard of a DTensor
    leaf) as a tensor like ``like``: a DTensor at its placements."""
    if not is_dtensor(like):
        return row
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(row, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


@contextlib.contextmanager
def on_mesh(mesh, rules=None, model=None):
    """Run sharded on ``mesh`` (``sharding_ctx`` with implicit replication,
    as ``ExecutionPlan.activate()``); ``rules`` default to the table of
    ``model.cfg.sharding_mode``. With no mesh, nothing."""
    if mesh is None:
        yield
        return
    with sharded(mesh, rules if rules is not None
                 else rules_for_mode(model.cfg.sharding_mode)):
        yield


def train_step(model, optimizer: Optimizer, opt_state: Dict[str, Any],
               batch: Dict[str, torch.Tensor], *,
               loss_fn: LossFn = model_loss, microbatches: int = 1,
               residuals: Optional[Dict[str, torch.Tensor]] = None,
               groups=None, mesh=None, rules=None) -> Dict[str, torch.Tensor]:
    """One training step, in place: the loss and gradients, int8 error
    feedback when ``residuals`` are given (updated in place), then the
    optimizer's update of the parameters and ``opt_state``; with ``mesh``,
    all of it under :func:`on_mesh`. Returns ``{"loss", "grad_norm"}`` as
    fp32 scalar tensors (not synchronised; a sharded loss is a DTensor)."""
    groups = groups if groups is not None else leaf_groups(model)
    with on_mesh(mesh, rules, model):
        loss, grads = value_and_grad(loss_fn, model, batch, microbatches)
        if residuals is not None:
            compress_with_feedback(grads, residuals, groups)
        gnorm = optimizer.update(grads, opt_state,
                                 dict(model.named_parameters()), groups)
    return {"loss": loss, "grad_norm": gnorm}


def batch_to_device(batch: Mapping[str, Any], model
                    ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on the model's device; floating inputs (the
    encoder-decoder's frames, the vision LM's patches) in the model's
    dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if t.is_floating_point():
            t = t.to(model.head["w"].dtype)
        out[k] = t.to(model.device)
    return out


class Trainer:
    def __init__(
        self,
        loss_fn: LossFn,                 # loss(model, batch) -> scalar
        optimizer: Optimizer,
        config: TrainerConfig,
        mesh=None,
        rules=None,
    ):
        """``mesh`` (a ``DeviceMesh``) and ``rules`` (a ``ShardingRules``;
        by default the model's mode's) run every step sharded; the model
        passed to :meth:`fit` must then hold DTensor parameters on that
        mesh, and the optimizer state placed (``plan.init_train_state``)."""
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.cfg = config
        self.mesh = mesh
        self.rules = rules
        self.ckpt = CheckpointManager(config.ckpt_dir, keep=config.keep)
        self.monitor = StragglerMonitor()
        self.injector: Optional[FailureInjector] = None

    # -- restore ---------------------------------------------------------------

    def init_residuals(self, model) -> Dict[str, torch.Tensor]:
        return init_residuals(model, leaf_groups(model),
                              self.cfg.compress_grads)

    def restore_latest(self, model, opt_state, residuals):
        """Resume from the newest checkpoint if one exists: the parameters
        are copied into ``model`` in place (a DTensor parameter takes its
        shard), the optimizer state and the residuals come back as new
        tensors on the model's device, each DTensor at the placements of
        the one it replaces."""
        step = self.ckpt.latest_step()
        if step is None:
            return 0, model, opt_state, residuals
        state = self.ckpt.restore(
            step, {"params": params_template(model), "opt": opt_state,
                   "res": residuals}, device=model.device)
        load_arrays(model, state["params"])
        return step, model, state["opt"], state["res"]

    def restore_elastic(self, step: int, template: Any, shardings: Any):
        """Restore the checkpoint of ``step`` onto a DIFFERENT mesh
        (elastic restart): ``shardings`` mirrors ``template`` with a
        ``(mesh, placements)`` per leaf (``ExecutionPlan.
        train_state_shardings`` gives them for a plan's mesh)."""
        return self.ckpt.restore(step, template, shardings=shardings)

    def save(self, step: int, model, opt_state, residuals, loss: float):
        self.ckpt.save(
            step, {"params": params_to_arrays(model), "opt": opt_state,
                   "res": residuals}, metadata={"loss": loss})

    # -- loop --------------------------------------------------------------------

    def fit(
        self,
        model,
        opt_state,
        data_iter_factory: Callable[[int], Iterator[Dict]],
        resume: bool = True,
    ):
        """Runs to cfg.steps. ``data_iter_factory(start_step)`` must return a
        stream positioned at start_step (deterministic resume). Returns
        ``(model, opt_state, history)``; the model's cached quantized
        weight copies are dropped at the end (or on a failure), so a
        trained model served quantized calibrates afresh."""
        if self.mesh is not None and not all(
                is_dtensor(p) for p in model.parameters()):
            raise ValueError("Trainer(mesh=...) trains a sharded model: "
                             "place it first (ExecutionPlan.shard_model)")
        groups = leaf_groups(model)
        residuals = self.init_residuals(model)
        start = 0
        if resume:
            start, model, opt_state, residuals = self.restore_latest(
                model, opt_state, residuals)
        data = data_iter_factory(start)
        history = []
        try:
            with on_mesh(self.mesh, self.rules, model):
                self._loop(model, opt_state, residuals, groups, data, start,
                           history)
        finally:
            model.reset_quantized()
        return model, opt_state, history

    def _loop(self, model, opt_state, residuals, groups, data, start,
              history):
        """The steps of :meth:`fit` from ``start``, appended to
        ``history``."""
        cfg = self.cfg
        for step in range(start, cfg.steps):
            if self.injector is not None:
                self.injector.check(step)
            batch = batch_to_device(next(data), model)
            # monotonic interval clock, read after the loss's .item()
            # has waited for the device
            t0 = time.perf_counter()
            metrics = train_step(
                model, self.optimizer, opt_state, batch,
                loss_fn=self.loss_fn, microbatches=cfg.microbatches,
                residuals=residuals if cfg.compress_grads else None,
                groups=groups)
            loss = float(local_value(metrics["loss"]))
            dt = time.perf_counter() - t0
            straggle = self.monitor.observe(step, dt)
            history.append({"step": step, "loss": loss, "dt": dt})
            if step % cfg.log_every == 0 or step == cfg.steps - 1:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"{dt*1e3:7.1f}ms"
                      + (" [straggler]" if straggle else ""))
            if (step + 1) % cfg.ckpt_every == 0 or step == cfg.steps - 1:
                self.save(step + 1, model, opt_state, residuals, loss)
