"""Prefill: back-to-back ``forward`` calls of fresh prompts, one client.

The traffic file gives ``batch``, ``seq`` and ``in_flight``, the calls
the client keeps queued on the card: it queues the next call before it
waits for the end of the oldest (a CUDA event), so that with two the card
does not wait for the host between calls. Every call's tokens are
uniform over the vocabulary, drawn on the card from the seed and the
call's index. The program is ``build_plan(..., ShapeSpec(seq, batch,
"prefill")).executable("prefill")`` on the seed's weights.

``prefill_tok_s``: the prompt tokens of every call that completes in the
window, over the time from the window's start to the end of the last
completed call. Correctness: the logits of ``check.calls`` calls (their
indices drawn from the seed among the window's first ``check.among``),
at ``check.rows`` rows each (drawn from the seed, with every sequence's
last position), against the reference's fp32 forward on the same tokens
and weights; the number compared is the worst row's relative error,
``|program - reference| / |reference|`` over the row's logits.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from portbench.frozen import flops
from portbench.harness import program
from portbench.harness.main import Check, Outcome, Window
from portbench.harness.seeds import generator, sub_seed
from portbench.harness.trace import Tracer
from portbench.harness.weights import reference_weights


class Done:
    """The point in the stream where the calls queued so far end."""

    def __init__(self, device):
        import torch

        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def prompts(ctx, call: int, device):
    """The token ids of call ``call`` (the warm-up is call -1)."""
    import torch

    mix = ctx.traffic
    gen = generator(device, ctx.seed, "prompts", call + 1)
    return torch.randint(0, ctx.cfg["vocab_size"],
                         (mix["batch"], mix["seq"]), generator=gen,
                         device=device, dtype=torch.int32)


def sampled(ctx):
    """``(call indices, rows)`` of the check, drawn from the seed."""
    chk = ctx.cell["check"]
    rng = np.random.default_rng(sub_seed(ctx.seed, "check"))
    calls = sorted(int(c) for c in rng.choice(chk["among"], chk["calls"],
                                              replace=False))
    B, S = ctx.traffic["batch"], ctx.traffic["seq"]
    last = [b * S + S - 1 for b in range(B)]
    rest = np.setdiff1d(np.arange(B * S), last)
    rows = np.sort(np.concatenate([last, rng.choice(
        rest, chk["rows"] - len(last), replace=False)]))
    return calls, rows


def run(ctx) -> Outcome:
    import torch

    dev = torch.device(ctx.device)
    B, S = ctx.traffic["batch"], ctx.traffic["seq"]
    plan, model = program.plan_and_model(
        ctx.cfg, ctx.seed, dev, shape=(ctx.name, S, B, "prefill"))
    step = plan.executable("prefill")
    calls, rows = sampled(ctx)
    rows_t = torch.as_tensor(rows, device=dev)

    for i in range(ctx.traffic.get("warm_calls", 1)):        # builds, warms
        logits = step.fn(model, {"tokens": prompts(ctx, -1 - i, dev)})
        if not bool(torch.isfinite(logits[:, -1]).all()):
            raise RuntimeError("non-finite logits in the warm-up")
        del logits
    if dev.type == "cuda":
        torch.cuda.synchronize()

    kept, flags, inflight, done, t_last = {}, [], collections.deque(), 0, None
    launches0 = program.kernel_launches()
    with Tracer(ctx.trace) as tracer:
        window = Window(ctx.seconds)
        while True:
            if window.open:
                call = done + len(inflight)
                logits = step.fn(model, {"tokens": prompts(ctx, call, dev)})
                if call in calls:
                    kept[call] = logits.view(B * S, -1).index_select(
                        0, rows_t)
                flags.append(torch.isfinite(logits[:, -1]).all())
                del logits
                inflight.append(Done(dev))
                if len(inflight) < ctx.traffic.get("in_flight", 1):
                    continue
            if not inflight:
                break
            inflight.popleft().wait()
            now = time.perf_counter()
            if now > window.end:
                break
            done += 1
            t_last = now
    failed = int((~torch.stack(flags[:done])).sum()) if done else 0
    launches = {k: v - launches0[k]
                for k, v in program.kernel_launches().items()}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del model, plan, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    elapsed = (t_last - window.start) if t_last else float("nan")
    done_kept = {c: kept[c] for c in calls if c < done}
    checks = check(ctx, done_kept, rows, dev)
    failed += len(calls) - len(done_kept)    # a sampled call never came
    return Outcome(
        metrics={"prefill_tok_s": (done * B * S / elapsed, "tokens/s")},
        attempted=done, failed=failed, checks=checks,
        window_start=window.start, window_s=tracer.window_s,
        memory_peak_bytes=peak, trace=tracer.summary(),
        counters={"calls": done, "elapsed_s": elapsed,
                  "model_flops": done * flops.prefill_flops(ctx.cfg, B, S),
                  **{f"launches.{k}": v for k, v in launches.items()}})


def reference_rows(ctx, W, call: int, rows, device, prec=None):
    """The reference's fp32 logits of call ``call`` at ``rows``."""
    import torch

    from portbench.reference import lm
    from portbench.reference.precision import FP32

    tokens = prompts(ctx, call, device)
    with torch.no_grad(), lm.fp32_matmul():
        h = lm.hidden(W, ctx.cfg, tokens, prec or FP32)
        h = h.reshape(-1, h.shape[-1]).index_select(
            0, torch.as_tensor(rows, device=device))
        return lm.head(W, h, prec or FP32)


def row_errors(got, want):
    """Each row's relative error, |got - want| / |want|, in fp32."""
    return ((got.float() - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-30))


def check(ctx, kept: dict, rows, device):
    worst = float("nan") if not kept else 0.0
    W = reference_weights(ctx.cfg, ctx.seed, device) if kept else None
    for call, got in kept.items():
        want = reference_rows(ctx, W, call, rows, device)
        worst = max(worst, float(row_errors(got, want).max()))
        del want
    return [Check("row_err_max", worst, ctx.cell["check"]["row_err_max"])]


def control(ctx) -> dict:
    """The control's reading at the cell's size: the reference in fp8
    (the precision below the configuration's bf16) against the fp32
    reference, on the rows the check samples."""
    import torch

    from portbench.reference.precision import Precision

    dev = torch.device(ctx.device)
    calls, rows = sampled(ctx)
    W = reference_weights(ctx.cfg, ctx.seed, dev)
    worst = 0.0
    for call in calls:
        want = reference_rows(ctx, W, call, rows, dev)
        got = reference_rows(ctx, W, call, rows, dev, Precision("fp8"))
        worst = max(worst, float(row_errors(got, want).max()))
    return {"row_err_max": worst}
