"""Async streaming serve front-end over the continuous scheduler.

``ServeBatcher.run()`` is a blocking drain. :class:`AsyncServeServer`
turns it into a resident serving loop without changing the step or the
scheduler:

* **requests arrive concurrently** — ``stream()`` / ``generate()`` are
  called from any number of asyncio tasks; submissions land on a
  thread-safe intake queue that the worker feeds to the batcher at
  micro-run boundaries (the scheduler's ``on_boundary`` hook), so a
  request arriving during a dispatch joins it;
* **tokens stream back per boundary** — the scheduler's ``on_tokens``
  hook fetches each micro-run's ``[k, slots]`` block and routes every
  live request its newly generated tokens; ``stream()`` yields them;
* **client disconnect maps to cancellation** — a consumer that abandons
  its stream (``break``, task cancelled, ``aclose``) enqueues a cancel
  that :meth:`ServeBatcher.cancel` applies at the next boundary;
* **deadline shedding surfaces as** :class:`RequestShed` — the waiting
  stream raises instead of hanging. The scheduler's clock is
  ``time.monotonic`` here, so ``DecodeRequest.deadline`` is wall-clock
  seconds;
* **a failure of the worker reaches every caller** — an exception raised
  by the dispatch loop fails every open stream with that exception and
  stops the worker; later submissions raise it too.

One worker thread owns ALL batcher and scheduler calls. Grad mode is
thread-local, so the worker enters ``torch.inference_mode()`` itself, and
it makes the plan's card the current device before it launches anything.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import queue
import threading
import time
from typing import AsyncIterator, Deque, Dict, List, Optional

import torch

from repro_torch.serve.batcher import (
    DecodeRequest,
    RequestResult,
    ServeBatcher,
    quantile,
)

_TTFT_WINDOW = 4096      # bounded: a resident server must not grow per-req


class RequestShed(RuntimeError):
    """The admission policy dropped this request (deadline already
    missed); it consumed no slot steps and produced no tokens."""


@dataclasses.dataclass
class _Stream:
    """Per-request plumbing between the worker thread and one consumer."""

    request: DecodeRequest
    queue: "asyncio.Queue"
    t_submit: float
    t_first: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    outcome: Optional[str] = None    # done | shed | cancelled | error
    result: Optional[RequestResult] = None


class AsyncServeServer:
    """Asyncio front-end for a continuous-schedule :class:`ServeBatcher`.

    Usage::

        server = AsyncServeServer(batcher)     # schedule="continuous"
        async with server:
            async for tok in server.stream(DecodeRequest("r0", [1, 2])):
                ...                            # per-micro-run tokens
            res = await server.generate(DecodeRequest("r1", [3, 4]))

    ``poll_s`` bounds the idle wake-up latency; once traffic flows,
    admission latency is micro-run boundaries, not polls.
    """

    def __init__(self, batcher: ServeBatcher, *, poll_s: float = 0.005):
        if batcher.scheduler is None:
            raise ValueError(
                "AsyncServeServer needs schedule='continuous' — the "
                "fixed-group fifo path has no boundary seam to stream "
                "from or cancel into")
        self.batcher = batcher
        self.poll_s = poll_s
        self._intake: "queue.Queue" = queue.Queue()
        self._streams: Dict[str, _Stream] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()
        self._error: Optional[BaseException] = None
        self.ttfts: Deque[float] = collections.deque(maxlen=_TTFT_WINDOW)
        self.totals: Deque[float] = collections.deque(maxlen=_TTFT_WINDOW)
        self.outcomes: Dict[str, int] = collections.defaultdict(int)

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> "AsyncServeServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._loop = asyncio.get_running_loop()
        self._stop_flag.clear()
        self._error = None
        sched = self.batcher.scheduler
        sched.on_boundary = self._boundary_hook
        sched.on_tokens = self._emit_tokens
        sched.on_shed = self._notify_shed
        sched.clock = time.monotonic
        self._thread = threading.Thread(target=self._worker,
                                        name="serve-worker", daemon=True)
        self._thread.start()
        return self

    async def stop(self) -> None:
        """Drain nothing, stop now: open streams end with an error."""
        if self._thread is None:
            return
        self._stop_flag.set()
        self._intake.put(("stop", None))
        await asyncio.get_running_loop().run_in_executor(
            None, self._thread.join)
        self._thread = None
        sched = self.batcher.scheduler
        sched.on_boundary = None
        sched.on_tokens = None
        sched.on_shed = None
        sched.clock = None
        for rid in list(self._streams):
            self._post(rid, ("error",
                             RuntimeError("server stopped mid-stream")))

    async def __aenter__(self) -> "AsyncServeServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- client API -----------------------------------------------------------

    def _register(self, request: DecodeRequest) -> _Stream:
        if self._thread is None:
            raise RuntimeError("server not started")
        rid = request.request_id
        if rid in self._streams:
            raise ValueError(f"duplicate request id {rid!r}: a stream "
                             "with this id is already open")
        s = _Stream(request, asyncio.Queue(), t_submit=time.monotonic())
        self._streams[rid] = s
        # checked after registering: the worker records its failure before
        # it fails the open streams, so no stream can miss it
        if self._error is not None:
            del self._streams[rid]
            raise RuntimeError("the serve worker failed") from self._error
        self._intake.put(("submit", request))
        return s

    async def _consume(self, s: _Stream) -> AsyncIterator[int]:
        rid = s.request.request_id
        try:
            while True:
                kind, payload = await s.queue.get()
                if kind == "tokens":
                    now = time.monotonic()
                    if s.t_first is None:
                        s.t_first = now
                        self.ttfts.append(now - s.t_submit)
                    s.tokens.extend(payload)
                    for tok in payload:
                        yield tok
                elif kind == "done":
                    s.outcome = "done"
                    s.result = payload
                    self.totals.append(time.monotonic() - s.t_submit)
                    return
                elif kind == "shed":
                    s.outcome = "shed"
                    raise RequestShed(
                        f"{rid}: deadline passed before admission")
                else:                      # "error"
                    s.outcome = "error"
                    raise payload
        finally:
            self._streams.pop(rid, None)
            if s.outcome is None:          # consumer walked away
                s.outcome = "cancelled"
                self._intake.put(("cancel", rid))
            self.outcomes[s.outcome] += 1

    async def stream(self, request: DecodeRequest) -> AsyncIterator[int]:
        """Submit and yield tokens as micro-run boundaries produce them.

        Abandoning the iterator cancels the request at the next boundary.
        Raises :class:`RequestShed` if the admission policy sheds it, and
        re-raises submission errors and worker failures.
        """
        gen = self._consume(self._register(request))
        try:
            async for tok in gen:
                yield tok
        finally:
            # close the inner generator NOW (not at GC) so the cancel
            # reaches the intake before the next boundary
            await gen.aclose()

    async def generate(self, request: DecodeRequest) -> RequestResult:
        """Consume the whole stream; returns the batcher's
        :class:`RequestResult`, the same record the blocking ``run()``
        yields."""
        s = self._register(request)
        async for _ in self._consume(s):
            pass
        return s.result

    # -- worker thread --------------------------------------------------------

    def _worker(self) -> None:
        device = self.batcher.plan.device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        with torch.inference_mode():
            try:
                self._serve()
            except BaseException as exc:    # reaches every open stream
                self._error = exc
                for rid in list(self._streams):
                    self._post(rid, ("error", exc))

    def _serve(self) -> None:
        batcher = self.batcher
        while True:
            try:
                item = self._intake.get(timeout=self.poll_s)
            except queue.Empty:
                item = None
            if item is not None:
                self._apply(item)
            self._drain_intake()
            if self._stop_flag.is_set():
                return
            if batcher._pending:
                for rid, res in batcher.run().items():
                    self._post(rid, ("done", res))

    def _drain_intake(self) -> None:
        while True:
            try:
                self._apply(self._intake.get_nowait())
            except queue.Empty:
                return

    def _apply(self, item) -> None:
        kind, payload = item
        if kind == "submit":
            try:
                self.batcher.submit(payload)
            except ValueError as exc:     # duplicate id, unservable shape
                self._post(payload.request_id, ("error", exc))
        elif kind == "cancel":
            self.batcher.cancel(payload)
        # "stop" only wakes the worker; the flag does the rest

    def _boundary_hook(self, pos, slots) -> None:
        # every micro-run boundary: submissions join the in-flight
        # dispatch and disconnects cancel into it
        self._drain_intake()

    # -- worker -> asyncio handoff -------------------------------------------

    def _post(self, rid: str, event) -> None:
        s = self._streams.get(rid)
        if s is None or self._loop is None:
            return
        try:
            self._loop.call_soon_threadsafe(s.queue.put_nowait, event)
        except RuntimeError:
            pass                           # loop already closed (shutdown)

    def _emit_tokens(self, deltas: Dict[str, List[int]]) -> None:
        for rid, toks in deltas.items():
            self._post(rid, ("tokens", toks))

    def _notify_shed(self, rid: str) -> None:
        self._post(rid, ("shed", None))

    # -- observability --------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        def pct(vals, p):
            return round(quantile(vals, p), 4)

        return {
            "open_streams": len(self._streams),
            "outcomes": dict(self.outcomes),
            "p50_ttft_s": pct(self.ttfts, 0.50),
            "p99_ttft_s": pct(self.ttfts, 0.99),
            "p50_total_s": pct(self.totals, 0.50),
            "p99_total_s": pct(self.totals, 0.99),
            "scheduler": self.batcher.scheduler.stats(),
        }
