"""The reference agrees with the port's CPU path on a tiny config. The
port runs with float32 parameters here (its float32 path computes every
product in float32, as the reference does), so the two agree to float32
round-off; the test may import both, the reference may not."""

import pytest
import torch

from portbench.harness import cells, program
from portbench.harness.main import Ctx
from portbench.harness.weights import fill_model, reference_weights
from portbench.reference import lm


def tiny_ctx(bench, cell, seed=7):
    w = cells.workload(cell, bench)
    return Ctx(bench, cell, w, cells.config(w["config"], bench),
               cells.traffic(w["traffic"], bench), seed, 0.0, False, "cpu")


def fp32_model(plan, cfg, seed):
    """The program's model in float32, holding the seed's (bf16) weights
    exactly."""
    from repro_torch.models.base import build_model

    bf16 = build_model(plan.cfg, device="cpu")
    fill_model(bf16, cfg, seed)
    model = build_model(plan.cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for (_, p), (_, q) in zip(model.named_parameters(),
                                  bf16.named_parameters()):
            p.copy_(q)
    return plan.load_params(model)


@pytest.mark.parametrize("variant", [
    {}, {"qkv_bias": True, "num_key_value_heads": 4}])
def test_prefill_logits_agree(tiny_bench, variant):
    """The cell's configuration, and a dense one with q, k, v biases and
    as many KV heads as query heads (Qwen1.5's layout), which a later cell
    can use without a change to the reference."""
    from repro_torch.models.base import ShapeSpec
    from repro_torch.plan import build_plan

    ctx = tiny_ctx(tiny_bench, "yi6b-prefill-2k")
    ctx.cfg = dict(ctx.cfg, **variant)
    prefill = cells.driver("prefill", tiny_bench)
    B, S = ctx.traffic["batch"], ctx.traffic["seq"]
    plan = build_plan(program.arch_config(ctx.cfg),
                      ShapeSpec("t", S, B, "prefill"), device="cpu")
    model = fp32_model(plan, ctx.cfg, ctx.seed)
    tokens = prefill.prompts(ctx, 0, torch.device("cpu"))
    got = plan.executable("prefill").fn(model, {"tokens": tokens})
    W = reference_weights(ctx.cfg, ctx.seed, "cpu")
    assert ("blocks.attn.wq.b" in W) == bool(variant)
    want = lm.head(W, lm.hidden(W, ctx.cfg, tokens))
    err = (got - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(err.max()) < 1e-5
