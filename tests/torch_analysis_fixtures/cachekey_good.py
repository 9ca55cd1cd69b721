"""Known-good twin for RA201, torch-flavoured: every parameter the step
builder binds flows through the key method into a CacheKey field. Never
imported."""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CacheKey:
    arch: str
    kind: str
    batch: int
    on_mesh: bool = False


def make_train_step(arch, batch, optimizer, mesh=None):
    def train_step(model, opt_state, tokens: torch.Tensor):
        return model(tokens), optimizer, mesh
    return train_step


class MiniPlan:
    def __init__(self, arch, cache, optimizer):
        self.arch = arch
        self.cache = cache
        self.optimizer = optimizer

    def _key(self, kind, batch, on_mesh=False):
        return CacheKey(arch=self.arch, kind=kind, batch=batch,
                        on_mesh=on_mesh)

    def executable(self, kind, batch, mesh=None):
        build = lambda: make_train_step(  # noqa: E731
            self.arch, batch, self.optimizer, mesh=mesh)
        key = self._key(kind, batch, on_mesh=mesh is not None)
        return self.cache.get_or_build(key, build)
