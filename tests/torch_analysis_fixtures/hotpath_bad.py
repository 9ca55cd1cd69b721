"""Known-bad fixture for RA401 (hot-path-purity), torch-flavoured. Never
imported.

Class names mirror the port's hot scopes (AdmissionPolicy subclass,
ContinuousScheduler boundary method, AsyncServeServer worker method,
boundary hook target) with a banned sync, transfer or allocation in
each.
"""

import time

import numpy as np
import torch


class AdmissionPolicy:
    def select(self, pending, fits, now):
        raise NotImplementedError


class SyncingPolicy(AdmissionPolicy):
    def select(self, pending, fits, now):
        torch.cuda.synchronize()               # RA401: sync per boundary
        budget = self._budget.item()           # RA401: sync + transfer
        return pending[:budget]


class ContinuousScheduler:
    def _admit(self, pending, freed):
        mask = torch.zeros(len(freed), dtype=torch.bool)  # RA401: alloc
        return mask

    def _free(self, slot):
        self._done.synchronize()               # RA401: event sync
        return self._lanes[slot].tolist()      # RA401: transfer


class AsyncServeServer:
    def _worker(self):
        time.sleep(0.01)                       # RA401: blocks dispatch
        return np.asarray(self._last)          # RA401: device fetch

    def _emit_tokens(self, toks):
        return toks.to("cpu").numpy()          # RA401: two transfers

    def _install(self, sched):
        sched.on_boundary = self._hook

    def _hook(self, boundary):
        return boundary.tokens.cpu()           # RA401: hook transfer
