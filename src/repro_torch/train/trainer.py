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
and ``chip_smoke.py`` do. The MoE's combine (``index_add_``) adds with
atomics on the card, so the MoE is not held to a bit-exact restart.
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


def value_and_grad(loss_fn: LossFn, model, batch: Dict[str, torch.Tensor],
                   microbatches: int = 1
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, grads)`` of ``loss_fn(model, batch)`` for every parameter
    of ``model``, by name.

    With one microbatch the gradients come in each parameter's dtype, as
    the reference's do. With N > 1 the batch splits into N along its first
    axis; the microbatch gradients are summed into fp32 buffers and scaled
    by 1/N (never summed through ``.grad`` in the parameter dtype), and
    the loss is the mean of the microbatch losses."""
    params = dict(model.named_parameters())
    tensors = list(params.values())
    with recording(tensors):
        if microbatches == 1:
            loss = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, tensors, materialize_grads=True)
            return loss.detach(), dict(zip(params, grads))
        for name, x in batch.items():
            if x.shape[0] % microbatches:
                raise ValueError(f"batch {name} of {x.shape[0]} rows does not "
                                 f"split into {microbatches} microbatches")
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for t in tensors]
        total = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
        for i in range(microbatches):
            micro = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                  *v.shape[1:])[i] for k, v in batch.items()}
            loss = loss_fn(model, micro)
            grads = torch.autograd.grad(loss, tensors, materialize_grads=True)
            for a, g in zip(acc, grads):
                a.add_(g)
            total = total + loss.detach()
            del loss, grads
    inv = 1.0 / microbatches
    return total * inv, {name: a.mul_(inv) for name, a in zip(params, acc)}


def init_residuals(model, groups, compress: bool) -> Dict[str, torch.Tensor]:
    """The error-feedback residuals, one per reference leaf: fp32 zeros of
    the leaf's shape with compression, else an fp32 zero scalar each (the
    reference's checkpoint layout either way)."""
    params = dict(model.named_parameters())
    dev = model.device
    return {g.name: torch.zeros(group_shape(g, params) if compress else (),
                                dtype=torch.float32, device=dev)
            for g in groups}


@torch.no_grad()
def compress_with_feedback(grads: Dict[str, torch.Tensor], residuals,
                           groups) -> None:
    """Int8 error feedback over each reference leaf (its max-scale spans
    the stacked leaf): replaces ``grads`` by their decoded fp32 values and
    ``residuals`` by the new residuals, in place."""
    for grp in groups:
        reduced, residuals[grp.name] = error_feedback_reduce(
            stacked(grads, grp), residuals[grp.name])
        rows = member_rows(reduced, grp)
        for i, name in enumerate(grp.members):
            grads[name] = rows[i]


def train_step(model, optimizer: Optimizer, opt_state: Dict[str, Any],
               batch: Dict[str, torch.Tensor], *,
               loss_fn: LossFn = model_loss, microbatches: int = 1,
               residuals: Optional[Dict[str, torch.Tensor]] = None,
               groups=None) -> Dict[str, torch.Tensor]:
    """One training step, in place: the loss and gradients, int8 error
    feedback when ``residuals`` are given (updated in place), then the
    optimizer's update of the parameters and ``opt_state``. Returns
    ``{"loss", "grad_norm"}`` as fp32 scalar tensors (not synchronised)."""
    groups = groups if groups is not None else leaf_groups(model)
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
    ):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.cfg = config
        self.ckpt = CheckpointManager(config.ckpt_dir, keep=config.keep)
        self.monitor = StragglerMonitor()
        self.injector: Optional[FailureInjector] = None

    # -- restore ---------------------------------------------------------------

    def init_residuals(self, model) -> Dict[str, torch.Tensor]:
        return init_residuals(model, leaf_groups(model),
                              self.cfg.compress_grads)

    def restore_latest(self, model, opt_state, residuals):
        """Resume from the newest checkpoint if one exists: the parameters
        are copied into ``model`` in place, the optimizer state and the
        residuals come back as new tensors on the model's device."""
        step = self.ckpt.latest_step()
        if step is None:
            return 0, model, opt_state, residuals
        state = self.ckpt.restore(
            step, {"params": params_template(model), "opt": opt_state,
                   "res": residuals}, device=model.device)
        load_arrays(model, state["params"])
        return step, model, state["opt"], state["res"]

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
        cfg = self.cfg
        groups = leaf_groups(model)
        residuals = self.init_residuals(model)
        start = 0
        if resume:
            start, model, opt_state, residuals = self.restore_latest(
                model, opt_state, residuals)
        data = data_iter_factory(start)
        history = []
        try:
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
                loss = float(metrics["loss"])
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
        finally:
            model.reset_quantized()
        return model, opt_state, history
