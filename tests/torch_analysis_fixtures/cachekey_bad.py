"""Known-bad fixture for RA201 (cachekey-completeness), torch-flavoured.
Never imported.

`mesh` decides what the bound train step runs on (it reaches the
builder) but never reaches the cache key: a step bound to the mesh and
one bound to no mesh would share one entry. The key method also passes a
keyword that is not a CacheKey field (`device`).
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CacheKey:
    arch: str
    kind: str
    batch: int


def make_train_step(arch, batch, optimizer, mesh=None):
    def train_step(model, opt_state, tokens: torch.Tensor):
        return model(tokens), optimizer, mesh
    return train_step


class MiniPlan:
    def __init__(self, arch, cache, optimizer):
        self.arch = arch
        self.cache = cache
        self.optimizer = optimizer

    def _key(self, kind, batch, device=None):
        # BUG: `device` is a parameter but never reaches CacheKey's
        # fields; it is passed under a name CacheKey does not have.
        return CacheKey(arch=self.arch, kind=kind, batch=batch,
                        device=torch.device(device or "cpu"))

    def executable(self, kind, batch, mesh=None):
        build = lambda: make_train_step(  # noqa: E731
            self.arch, batch, self.optimizer, mesh=mesh)
        key = self._key(kind, batch)     # BUG: mesh unkeyed
        return self.cache.get_or_build(key, build)
