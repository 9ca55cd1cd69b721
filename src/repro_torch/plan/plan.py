"""``build_plan`` and :class:`ExecutionPlan`: the one execution API of the
port, for one card.

    from repro_torch.plan import build_plan
    plan = build_plan("yi-6b", shape=ShapeSpec("p", 2048, 2, "prefill"))
    model = plan.init_params(seed=0)       # random weights on the card
    prefill = plan.executable("prefill")   # bound step, cached, counted
    logits = prefill.fn(plan.model, {"tokens": tokens})

The plan owns the model (its parameters), the quantization decisions and
every step function; the serving batcher is a thin consumer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core.emit import DeviceLike
from repro_torch.launch.steps import (
    make_prefill_decode_step,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.models.base import SHAPES, ArchConfig, ShapeSpec, build_model
from repro_torch.plan.ir import PlanIR
from repro_torch.plan.passes import PLAN_PIPELINE, calibrate_mlp_shifts
from repro_torch.serve.cache import CachedExecutable, CacheKey, ExecutableCache


class ExecutionPlan:
    """A resolved execution recipe: device + quantization + the step
    catalogue. Construct via :func:`build_plan`."""

    def __init__(self, ir: PlanIR, cache: Optional[ExecutableCache] = None):
        self.ir = ir
        self.cache = cache or ExecutableCache()
        self._model = None
        self._built_any = False

    # -- resolved views -------------------------------------------------------

    @property
    def cfg(self) -> ArchConfig:
        return self.ir.cfg

    @property
    def device(self) -> torch.device:
        return self.ir.device

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

    # -- parameters / state ---------------------------------------------------

    def init_params(self, seed: int = 0):
        """Random parameters on the plan's device (demos, benchmarks,
        tests); calibrates the quantization shifts. Returns the model."""
        model = build_model(self.cfg, device=self.device).init_params(seed)
        return self._install(model)

    def load_params(self, params):
        """Install a ``DecoderLM`` or the reference's parameter tree as
        numpy arrays (see ``repro_torch.bridge.decoder_lm_from_arrays``),
        then calibrate. Returns the model."""
        from repro_torch.models.lm import DecoderLM

        if not isinstance(params, DecoderLM):
            from repro_torch.bridge import decoder_lm_from_arrays

            params = decoder_lm_from_arrays(self.cfg, params, self.device)
        if params.device != self.device:
            raise ValueError(f"model is on {params.device}, the plan on "
                             f"{self.device}")
        return self._install(params)

    def _install(self, model):
        model.cfg = self.cfg
        model.reset_quantized()
        self._model = model
        self.calibrate()
        return model

    def fresh_decode_state(self, batch: int, max_len: int):
        """A zeroed decode state for one bucket shape."""
        return self.model.decode_state(batch, max_len)

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
             prefill_len: int = 0) -> CacheKey:
        return CacheKey(
            arch=self.cfg.name, kind=kind, batch=batch, max_len=max_len,
            prefill_len=prefill_len, mode=self.mode,
            mesh_axes=CacheKey.device_signature(self.device),
            quantized=self.cfg.quantized, qsig=self._qsig(),
        )

    def executable(self, kind: Optional[str] = None) -> CachedExecutable:
        """The step for this plan's ShapeSpec ("prefill" or "decode"),
        built once through the ExecutableCache and counted."""
        shape = self.shape
        if shape is None:
            raise ValueError(
                "this plan has no pinned ShapeSpec (serve plans build "
                "per-bucket steps via serve_executable)")
        kind = kind or shape.kind
        builders = {
            "prefill": lambda: make_prefill_step(self.cfg, shape),
            "decode": lambda: make_serve_step(self.cfg, shape),
        }
        if kind == "train":
            raise NotImplementedError(
                "training is not ported yet (ROADMAP Queue 1 item 13)")
        if kind not in builders:
            raise ValueError(f"unknown executable kind {kind!r}")
        key = self._key(kind, shape.global_batch, shape.seq_len)
        self._built_any = True
        return self.cache.get_or_build(key, builders[kind])

    def serve_executable(self, kind: str, *, batch: int, max_len: int,
                         prefill_len: int = 0) -> CachedExecutable:
        """A bucketed serving step: ``kind`` is "decode" (one token against
        resident state) or "prefill" (the prefill->decode handoff loop
        over a prompt block padded to ``prefill_len``)."""
        if kind == "decode":
            shape = ShapeSpec(f"b{batch}xl{max_len}", max_len, batch,
                              "decode")
            build = lambda: make_serve_step(self.cfg, shape)  # noqa: E731
        elif kind == "prefill":
            build = lambda: make_prefill_decode_step(  # noqa: E731
                self.cfg, batch, prefill_len, max_len)
        elif kind == "masked_decode":
            raise NotImplementedError(
                "the masked continuous-batching step is not ported yet "
                "(ROADMAP Queue 1 item 11)")
        else:
            raise ValueError(f"unknown serve executable kind {kind!r}")
        key = self._key(kind, batch, max_len, prefill_len)
        self._built_any = True
        return self.cache.get_or_build(key, build)

    @staticmethod
    def token_argmax(logits: torch.Tensor) -> torch.Tensor:
        """Greedy token selection: int32 argmax over the vocab."""
        return torch.argmax(logits, dim=-1).to(torch.int32)

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
            "quantized": ir.quantized,
            "quant": dict(ir.quant),
            "executables": ir.executables,
            "passes": [{"pass": name, **entry}
                       for name, entry in ir.decisions],
            "cache": self.cache.stats(),
        }


def build_plan(
    arch: Union[str, ArchConfig],
    shape: Union[str, ShapeSpec, None] = None,
    *,
    quantized: bool = False,
    debug: bool = False,
    config_overrides: Optional[Dict[str, Any]] = None,
    cache: Optional[ExecutableCache] = None,
    device: DeviceLike = None,
) -> ExecutionPlan:
    """Run the plan pass pipeline and return the ExecutionPlan.

    ``arch`` is an architecture alias ("yi-6b") or an ArchConfig; ``shape``
    a ShapeSpec / SHAPES name, or None for a serve plan whose shapes come
    per bucket. ``debug`` picks the reduced config. ``device`` defaults to
    the card (and raises without one).
    """
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        from repro_torch.configs import get_config, reduced_config

        cfg = reduced_config(arch) if debug else get_config(arch)
    if config_overrides:
        cfg = cfg.with_(**config_overrides)
    if isinstance(shape, str):
        shape = SHAPES[shape]
    ir = PlanIR(cfg=cfg, shape=shape, mode=cfg.sharding_mode,
                device_request=device, quantized=quantized)
    for _name, pass_fn in PLAN_PIPELINE:
        ir = pass_fn(ir)
    return ExecutionPlan(ir, cache)
