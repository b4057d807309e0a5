"""Serving plumbing: CORS, keep-alive lock acquisition, and the
engine→asyncio event bridge.

The engine runs in a worker thread; its events cross into the loop through
an unbounded queue (a vanished client can never wedge the engine thread), an
abort flag stops generation between events on disconnect, and idle gaps
surface as ``None`` ticks so handlers can write SSE keep-alive comments
while the single decode stream is busy elsewhere (1 s, as the reference).
"""

from __future__ import annotations

import asyncio
import contextlib
import threading
from typing import AsyncIterator

from aiohttp import web

from ..utils import Event

KEEPALIVE_S = 1.0


def cors(resp: web.StreamResponse) -> web.StreamResponse:
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
    resp.headers["Access-Control-Allow-Headers"] = "*"
    return resp


def json_response(data, status: int = 200) -> web.Response:
    return cors(web.json_response(data, status=status))


async def sse_response(request: web.Request) -> web.StreamResponse:
    resp = web.StreamResponse(headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
        "Connection": "keep-alive",
    })
    cors(resp)
    await resp.prepare(request)
    return resp


async def acquire_with_keepalive(lock: asyncio.Lock,
                                 resp: web.StreamResponse) -> bool:
    """Acquire the decode lock, writing SSE keep-alive comments while queued
    (or proxies drop queued requests before generation starts). Returns False
    — with the lock NOT held — if the client vanished while waiting."""
    while True:
        try:
            await asyncio.wait_for(lock.acquire(), timeout=KEEPALIVE_S)
            return True
        except asyncio.TimeoutError:
            try:
                await resp.write(b": keep-alive\n\n")
            except (ConnectionResetError, asyncio.CancelledError):
                return False


async def engine_events(engine, prompt, gen, abort: threading.Event,
                        ) -> AsyncIterator[Event | None]:
    """Yield the events of ``engine.generate`` (an Engine or a
    SlotScheduler); ``None`` marks an idle gap of
    ``KEEPALIVE_S`` (handlers turn it into a keep-alive). An engine failure becomes a
    terminal ``done`` event carrying ``data["error"]``, never an exception.

    The finally clause joins the worker thread, but an async generator's
    finally runs only when the generator is closed: callers that may break
    early iterate under ``contextlib.aclosing`` so the join happens before
    the decode lock is released."""
    queue: asyncio.Queue = asyncio.Queue()
    loop = asyncio.get_running_loop()
    DONE = object()

    def run() -> None:
        try:
            # closing: on abort the generator is closed here, on the worker
            # thread, so a scheduler stream frees its slot at the next chunk
            # boundary instead of whenever the collector runs
            with contextlib.closing(engine.generate(prompt, gen)) as events:
                for ev in events:
                    if abort.is_set():
                        break
                    loop.call_soon_threadsafe(queue.put_nowait, ev)
        except Exception as e:  # routed: it becomes the client's terminal done event
            err = Event("done", f"engine error: {e!r}",
                        data={"error": repr(e), "finish_reason": "error"})
            loop.call_soon_threadsafe(queue.put_nowait, err)
        finally:
            loop.call_soon_threadsafe(queue.put_nowait, DONE)

    task = loop.run_in_executor(None, run)
    try:
        while True:
            try:
                item = await asyncio.wait_for(queue.get(), timeout=KEEPALIVE_S)
            except asyncio.TimeoutError:
                yield None
                continue
            if item is DONE:
                break
            yield item
    finally:
        abort.set()
        await task
