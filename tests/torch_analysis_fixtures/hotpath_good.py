"""Known-good twin for RA401, torch-flavoured: the same scopes doing
host-only bookkeeping. Never imported. ``torch.cuda.set_device`` binds
the worker thread to its card once: no sync, not banned."""

import collections

import torch


class AdmissionPolicy:
    def select(self, pending, fits, now):
        raise NotImplementedError


class FifoLikePolicy(AdmissionPolicy):
    def select(self, pending, fits, now):
        return [r for r in pending if fits(r)]


class ContinuousScheduler:
    def _admit(self, pending, freed):
        taken = collections.deque()
        for slot in freed:
            if pending:
                taken.append((slot, pending.pop(0)))
        return taken


class AsyncServeServer:
    def _worker(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while self._live:
            self._drain_intake()

    def _drain_intake(self):
        self._queue.extend(self._intake)
        self._intake.clear()

    def _install(self, sched):
        sched.on_boundary = self._hook

    def _hook(self, boundary):
        self._seen.append(boundary.step)
