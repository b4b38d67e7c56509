"""Async continuous-serving front-end: many concurrent clients, ONE engine
(port of src/repro/serving/frontend.py).

``ServingEngine`` is single-threaded by design — every structure it owns
(queue, slots, page pool, metrics registry) assumes exactly one caller
drives ``submit()``/``step()``.  ``AsyncEngine`` keeps that invariant
while serving concurrent clients by the ACTOR pattern:

      client tasks                      owner task (one per engine)
    ──────────────                    ─────────────────────────────
    await submit()  ──┐
    await submit()  ──┼──▶  mailbox  ──▶  drain FIFO ─▶ engine.submit()
    cancel()        ──┘   (deque+event)   engine.step()
                                            │ RequestOutputs
         ◀──────── per-request asyncio.Queue┘  (fan-out by req_id)

Clients never touch the engine.  They post messages (submit / abort)
into a mailbox; a single background OWNER task drains the mailbox in
FIFO order, runs one ``engine.step()`` when work is live, and fans each
``RequestOutput`` out to its request's private ``asyncio.Queue``.  A
client consumes its stream with ``async for`` and cancels by dropping
the stream (``stream()`` aborts the request on the way out).

DETERMINISM: this design is deterministic BY CONSTRUCTION, not by a
mode switch.  The mailbox is drained in the order clients posted
(posting happens synchronously inside ``submit()`` before its first
``await``), so request ids and derived seeds match the synchronous
engine fed the same submissions in the same order; and greedy token
streams are batch-composition-independent (the invariant the serving
test-suite pins), so WHATEVER tick interleaving the event loop produces,
greedy streams equal the synchronous engine's token for token.

The owner task calls ``engine.step()`` inline (the event loop blocks for
the tick's duration, then yields): ticks are the unit of progress and
everything a client does between ticks is queue operations, so a
thread-pool handoff would buy responsiveness measured in microseconds at
the price of cross-thread engine state — and on a CUDA device the
engine's stream and the caching allocator are not shared safely across
threads that way.  ``step()`` blocks on its one packed host transfer a
program call; the loop yields between ticks.  Single host, single
engine — scaling across engines is a layer above this one.
"""

from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass
from typing import Any, AsyncIterator, Deque, Dict, List, Optional, Union

import numpy as np

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.metrics import SLO
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.types import Request, RequestOutput

__all__ = [
    "AsyncEngine",
    "AsyncRequest",
]


@dataclass
class _Submit:
    prompt: np.ndarray
    kwargs: Dict[str, Any]
    future: asyncio.Future


@dataclass
class _Abort:
    req_id: int
    future: Optional[asyncio.Future]


class AsyncRequest:
    """A client's handle on one in-flight request.

    Async-iterable: ``async for out in handle`` yields each incremental
    ``RequestOutput`` and ends after the terminal one (``finished=True``
    — reason "length"/"eos"/"stop", or "abort"/"shed" for a request that
    never ran).  ``token_ids()``/``finish_reason`` read the accumulated
    result after the stream ends."""

    def __init__(self, request: Request, frontend: "AsyncEngine"):
        self.request = request
        self._frontend = frontend
        self.outputs: asyncio.Queue = asyncio.Queue()
        self.finished = False

    @property
    def req_id(self) -> int:
        return self.request.req_id

    @property
    def finish_reason(self) -> Optional[str]:
        return self.request.finish_reason

    def token_ids(self) -> List[Any]:
        return list(self.request.generated)

    def __aiter__(self) -> "AsyncRequest":
        return self

    async def __anext__(self) -> RequestOutput:
        if self.finished:
            raise StopAsyncIteration
        out = await self.outputs.get()
        if isinstance(out, BaseException):
            self.finished = True
            raise out
        if out.finished:
            self.finished = True
        return out


class AsyncEngine:
    """The asyncio front-end over one ``ServingEngine`` (see module doc).

    Use as an async context manager (starts/stops the owner task), or
    call ``start()`` / ``await aclose()`` explicitly::

        async with AsyncEngine(engine) as fe:
            h = await fe.submit(prompt, sampling=SamplingParams(...))
            async for out in h:
                ...

    ``aclose()`` aborts every in-flight request before stopping, so a
    client that forgets a stream cannot leak pool pages.
    """

    def __init__(self, engine: ServingEngine):
        self.engine = engine
        self._mailbox: Deque[Union[_Submit, _Abort]] = deque()
        self._wake = asyncio.Event()
        self._handles: Dict[int, AsyncRequest] = {}
        self._task: Optional[asyncio.Task] = None
        self._closing = False
        self._error: Optional[BaseException] = None

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        if self._task is None or self._task.done():
            self._closing = False
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="async-engine-owner")

    async def aclose(self) -> None:
        """Abort in-flight requests, stop the owner task, surface any
        engine error it died on."""
        if self._task is None:
            return
        self._closing = True
        self._wake.set()
        task, self._task = self._task, None
        await task

    async def __aenter__(self) -> "AsyncEngine":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    # -- client API ------------------------------------------------------------
    async def submit(self, prompt: np.ndarray,
                     max_new_tokens: Optional[int] = None,
                     eos_id: Optional[int] = None, *,
                     sampling: Optional[SamplingParams] = None,
                     slo: Optional[SLO] = None,
                     priority: Optional[int] = None) -> AsyncRequest:
        """Post one request to the engine; resolves once the OWNER task
        has run ``engine.submit`` (so ``handle.req_id`` is final).  The
        handle may come back already terminal: admission shed yields one
        ``finished`` output with reason "shed" and no tokens.

        Submission ORDER is the posting order — concurrent clients that
        each ``await submit(...)`` sequentially get consecutive ids, and
        the same prompts posted in the same order always derive the same
        per-request seeds (the determinism the identity tests pin)."""
        self._require_running()
        fut = asyncio.get_running_loop().create_future()
        self._mailbox.append(_Submit(
            prompt, dict(max_new_tokens=max_new_tokens, eos_id=eos_id,
                         sampling=sampling, slo=slo, priority=priority),
            fut))
        self._wake.set()
        return await fut

    async def stream(self, prompt: np.ndarray,
                     max_new_tokens: Optional[int] = None,
                     eos_id: Optional[int] = None, *,
                     sampling: Optional[SamplingParams] = None,
                     slo: Optional[SLO] = None,
                     priority: Optional[int] = None
                     ) -> AsyncIterator[RequestOutput]:
        """submit + iterate, with DISCONNECT SEMANTICS: if the consumer
        stops early — ``break``, task cancellation, client gone — the
        request is aborted, releasing its slot and pool pages.  This is
        the one-call path a network handler should use."""
        handle = await self.submit(prompt, max_new_tokens, eos_id,
                                   sampling=sampling, slo=slo,
                                   priority=priority)
        try:
            async for out in handle:
                yield out
        finally:
            if not handle.finished:
                # post-only (no await): safe under CancelledError /
                # GeneratorExit, where awaiting would re-raise
                self.cancel(handle.req_id)

    def cancel(self, req_id: int) -> None:
        """Fire-and-forget abort (safe from ``finally`` during
        cancellation).  The owner task aborts the request before its
        next tick; the handle's stream receives the terminal "abort"
        output."""
        if self._task is None or self._task.done():
            return
        self._mailbox.append(_Abort(req_id, None))
        self._wake.set()

    async def abort(self, req_id: int) -> Optional[RequestOutput]:
        """Abort and wait for the terminal output (None if the id is
        unknown or already finished)."""
        self._require_running()
        fut = asyncio.get_running_loop().create_future()
        self._mailbox.append(_Abort(req_id, fut))
        self._wake.set()
        return await fut

    async def drain(self) -> None:
        """Wait until every posted request has retired (the engine and
        mailbox are both empty).  Test/bench convenience — production
        clients just consume their streams."""
        self._require_running()
        while (self._mailbox or self._handles
               or self.engine._live()):        # noqa: SLF001 (owner facade)
            if self._error is not None:
                raise self._error
            await asyncio.sleep(0)
        if self._error is not None:
            raise self._error

    def _require_running(self) -> None:
        if self._error is not None:
            raise self._error
        if self._task is None or self._task.done():
            raise RuntimeError(
                "AsyncEngine is not running — use 'async with "
                "AsyncEngine(engine)' or call start() first")

    # -- owner task ------------------------------------------------------------
    def _drain_mailbox(self) -> None:
        """Apply every queued client message in FIFO order.  Runs ONLY in
        the owner task — the single place ``engine.submit``/``abort``
        are ever called from."""
        while self._mailbox:
            msg = self._mailbox.popleft()
            if isinstance(msg, _Submit):
                try:
                    req = self.engine.submit(msg.prompt, **msg.kwargs)
                except BaseException as e:           # invalid prompt etc.
                    if not msg.future.cancelled():
                        msg.future.set_exception(e)
                    continue
                handle = AsyncRequest(req, self)
                if req.finish_reason == "shed":
                    # terminal at admission: one finished output, stream
                    # ends immediately — the client sees the refusal the
                    # same way it sees any other terminal state
                    handle.outputs.put_nowait(RequestOutput(
                        req_id=req.req_id, new_token_ids=[], n_generated=0,
                        finished=True, finish_reason="shed"))
                else:
                    self._handles[req.req_id] = handle
                if not msg.future.cancelled():
                    msg.future.set_result(handle)
            else:
                out = self.engine.abort(msg.req_id)
                if out is not None:
                    self._dispatch(out)
                if msg.future is not None and not msg.future.cancelled():
                    msg.future.set_result(out)

    def _dispatch(self, out: RequestOutput) -> None:
        handle = self._handles.get(out.req_id)
        if handle is None:
            return
        handle.outputs.put_nowait(out)
        if out.finished:
            del self._handles[out.req_id]

    async def _run(self) -> None:
        """The owner loop: drain mailbox -> one tick -> fan out -> yield.

        ``asyncio.sleep(0)`` between ticks hands the loop to every ready
        client exactly once, so submissions posted while a tick ran are
        admitted before the next one — continuous batching across the
        async boundary."""
        try:
            while True:
                self._drain_mailbox()
                if self._closing:
                    break
                if self.engine._live():          # noqa: SLF001 (owner facade)
                    for out in self.engine.step():
                        self._dispatch(out)
                    await asyncio.sleep(0)
                else:
                    self._wake.clear()
                    if self._mailbox or self._closing:
                        continue
                    await self._wake.wait()
        except BaseException as e:
            self._error = e
            self._fail_inflight(e)
            raise
        finally:
            if self._error is None:
                self._close_inflight()

    def _fail_inflight(self, e: BaseException) -> None:
        for handle in self._handles.values():
            handle.outputs.put_nowait(e)
        self._handles.clear()
        for msg in self._mailbox:
            if msg.future is not None and not msg.future.done():
                msg.future.set_exception(e)
        self._mailbox.clear()

    def _close_inflight(self) -> None:
        """Clean shutdown with clients still attached: abort each live
        request so streams terminate and the engine releases its state."""
        for req_id in list(self._handles):
            out = self.engine.abort(req_id)
            if out is not None:
                self._dispatch(out)
            else:
                self._handles.pop(req_id, None)
        for msg in self._mailbox:
            if msg.future is not None and not msg.future.done():
                msg.future.set_exception(
                    RuntimeError("AsyncEngine closed before the request "
                                 "was accepted"))
        self._mailbox.clear()
