"""Micro-batching policy wrapper: serve several robots from one card (port
of ``lap_tpu/policies/batching.py``).

The reference serves strictly one request at a time (lihzha/lap
``serve_policy.py:92-107``: one websocket handler, one model call per
request). ``BatchingPolicy`` wraps a :class:`~lap_tpu_torch.policies.policy.Policy`
or ``ARPolicy``. Host-side input transforms run on the caller's thread (they
parallelize); transformed inputs are coalesced by a single worker into one
batched model call of exactly as many rows as requests. The JAX package pads
each batch up to a bucket ladder (1, 2, 4, ... up to ``max_batch``) because
each bucket there is one compiled executable; nothing compiles here, so a
padded row would only be device work for nothing. The request signature
that decides which requests may stack is the port's own flatten of nested
dicts (JAX: ``jax.tree_util.tree_flatten``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from lap_tpu_torch.policies.policy import BasePolicy


@dataclasses.dataclass
class _Pending:
    inputs: dict
    future: Future
    batch_size: int = 0


def _flatten_tree(tree, path: tuple = ()) -> list[tuple[tuple, object]]:
    """(key path, leaf) pairs of nested dicts in sorted key order; ``None``
    is an empty subtree, as in ``jax.tree_util.tree_flatten``."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _flatten_tree(tree[k], (*path, k))]
    return [] if tree is None else [(path, tree)]


def _signature(inputs: dict):
    """Tree structure + leaf shapes/dtypes: only like-shaped requests can
    stack into one device batch. String-ish leaves group by dtype KIND, not
    exact width: different prompt texts must still coalesce."""
    flat = _flatten_tree(inputs)
    sig = []
    for _, x in flat:
        a = np.asarray(x)
        dt = a.dtype.kind if a.dtype.kind in ("U", "S", "O") else str(a.dtype)
        sig.append((a.shape, dt))
    return tuple(path for path, _ in flat), tuple(sig)


class BatchingPolicy(BasePolicy):
    """Coalesce concurrent ``infer`` calls into batched device calls.

    Args:
        policy: the wrapped Policy/ARPolicy (anything with ``_prepare`` and
            ``_infer_prepared``).
        max_batch: largest batch per device call.
        window_ms: after the first request of a batch arrives, how long to
            wait for companions. At robot control rates (15 Hz = 66 ms
            period) a few ms collects every concurrently-pending request
            without adding visible latency.

    The JAX package's bucket ladder, ``warmup`` and ``background_warmup``
    (compiling each bucket) are not ported: nothing compiles here.
    """

    def __init__(
        self,
        policy,
        *,
        max_batch: int = 4,
        window_ms: float = 5.0,
    ):
        super().__init__(metadata=policy.metadata)
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._policy = policy
        self._max_batch = max_batch
        self._window_s = window_ms / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        # Orders infer()'s enqueue against close()'s sentinel: an item is
        # either ahead of the sentinel (the worker serves it) or the enqueue
        # raises: a Future can never be left unresolved.
        self._close_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "largest_batch": 0}
        self._worker = threading.Thread(
            target=self._loop, name="lap-batcher", daemon=True
        )
        self._worker.start()

    def infer(self, obs: dict) -> dict:
        t_start = time.monotonic()
        item = _Pending(self._policy._prepare(obs), Future())
        with self._close_lock:
            if self._closed:
                raise RuntimeError("BatchingPolicy is closed")
            self._queue.put(item)
        result = item.future.result()
        result["policy_timing"] = {
            "infer_ms": (time.monotonic() - t_start) * 1000.0,
            "batch_size": item.batch_size,
        }
        return result

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=30.0)
        # The worker flushes everything ahead of the sentinel before exiting;
        # after the join the queue is empty unless the worker is wedged in a
        # device call past the timeout — then fail the stranded items but
        # keep the sentinel so the worker still exits when it recovers.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                if self._worker.is_alive():
                    self._queue.put(None)
                break
            item.future.set_exception(RuntimeError("BatchingPolicy closed"))

    # ------------------------------------------------------------------

    def _collect(self, first: _Pending) -> list[_Pending] | None:
        """Gather companions for up to window_ms, then drain instantly-
        available ones. Returns None on shutdown sentinel."""
        items = [first]
        deadline = time.monotonic() + self._window_s
        while len(items) < self._max_batch:
            timeout = deadline - time.monotonic()
            try:
                nxt = (
                    self._queue.get(timeout=timeout)
                    if timeout > 0
                    else self._queue.get_nowait()
                )
            except queue.Empty:
                break
            if nxt is None:
                # Shutdown: flush what we have, then stop.
                self._dispatch(items)
                return None
            items.append(nxt)
        return items

    def _dispatch(self, items: list[_Pending]) -> None:
        """Group like-shaped requests and run each group as one batch: a
        malformed/odd-shaped request must fail alone, not poison (and, via
        the server's error handling, disconnect) healthy companions."""
        groups: dict = {}
        for it in items:
            try:
                key = _signature(it.inputs)
            except Exception as e:  # noqa: BLE001 - unhashable/odd leaf
                it.future.set_exception(e)
                continue
            groups.setdefault(key, []).append(it)
        for group in groups.values():
            self._run_batch(group)

    def _run_batch(self, items: list[_Pending]) -> None:
        self.stats["requests"] += len(items)
        self.stats["batches"] += 1
        self.stats["largest_batch"] = max(self.stats["largest_batch"], len(items))
        try:
            results = self._policy._infer_prepared([it.inputs for it in items])
        except BaseException as e:  # noqa: BLE001 - must not kill the worker
            for it in items:
                it.future.set_exception(e)
            return
        for it, result in zip(items, results):
            it.batch_size = len(items)
            it.future.set_result(result)

    def _loop(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:
                return
            items = self._collect(first)
            if items is None:
                return
            self._dispatch(items)
