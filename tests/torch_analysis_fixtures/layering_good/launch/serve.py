"""Known-good twin for RA501, torch-flavoured: a genuinely thin plan
client. Never imported. Config in, plan out, steps only via the plan,
and the serve path's grad mode from the plan."""

from repro_torch.configs import get_config
from repro_torch.models import SHAPES
from repro_torch.plan import build_plan


def main(arch: str, bucket_batch: int, bucket_len: int):
    plan = build_plan(get_config(arch), None, mode="cascade")
    exe = plan.serve_executable(
        "masked_decode", batch=bucket_batch, max_len=bucket_len)
    with plan.serving_grad_mode():
        return plan, exe, SHAPES
