"""Known-good twin for RA501: a batcher that takes its steps and its
grad mode from the plan. Never imported."""

from repro_torch.serve.cache import ExecutableCache


class ServeBatcher:
    def __init__(self, plan):
        self.plan = plan
        self.cache = plan.cache if plan is not None else ExecutableCache()

    def run(self, bucket):
        exe = self.plan.serve_executable("decode", batch=bucket.batch,
                                         max_len=bucket.max_len)
        with self.plan.serving_grad_mode():
            return exe.fn(self.plan.model)
