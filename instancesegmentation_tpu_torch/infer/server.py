"""Dynamic-batching serving front-end.

Port of ``instancesegmentation_tpu/infer/server.py``, unchanged apart from
importing the port's request helpers (``infer/proposals.py``).  Concurrent
callers submit requests and get futures; a collator thread groups pending
requests into device dispatches (up to ``max_batch``, waiting at most
``max_delay_ms`` for stragglers), so device utilisation follows the
engine's bucketed batch programs instead of the callers' arrival pattern.

Two request types share the collator:

- whole-image (``submit``): RGB image -> 0/255 mask at the image's own
  resolution (engine ``predict_images``).
- instance (``submit_instance``): (image, box, keypoints?) -> mask, the
  keypoint-conditioned crop-and-segment program, batched into the
  engine's ``predict_instances`` buckets.

This layer is host-side orchestration only: stdlib threads and futures,
safe to embed in any HTTP/RPC wrapper, over any engine exposing
``predict_images`` / ``predict_instances`` and ``threshold``.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np


class ServingFrontend:
    """Batch single requests into engine dispatches.

    ``engine`` needs a ``predict_images(list[np.ndarray]) ->
    list[np.ndarray]`` method for whole-image requests and a
    ``predict_instances(batch) -> (probs, canvas_masks)`` method plus a
    ``threshold`` attribute for instance requests
    (infer.pipeline.InferenceEngine or anything duck-typed to it).

    ``max_queue`` bounds the request queue: a client flood then fails
    fast with ``queue.Full`` at submit time (backpressure) instead of
    buffering unboundedly many decoded images in RAM.  0 keeps the queue
    unbounded.
    """

    def __init__(self, engine, max_batch: int = 32, max_delay_ms: float = 3.0,
                 max_queue: int = 1024, canvas: int = 640):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self.canvas = int(canvas)
        self._q: queue.Queue = queue.Queue(maxsize=int(max_queue))
        self._closed = threading.Event()
        # serializes submit()'s closed-check+put against close()'s
        # set+sentinel: without it a preempted submit could land its
        # item AFTER the worker's final drain, leaving the future
        # permanently unresolved
        self._submit_lock = threading.Lock()
        self.dispatches = 0          # observability: device calls attempted
        self.served = 0              # requests completed
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- client side ---------------------------------------------------
    def _enqueue(self, item) -> None:
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("ServingFrontend is closed")
            # non-blocking put: raises queue.Full when the bound is hit,
            # so overload surfaces at the caller instead of as RSS
            self._q.put_nowait(item)

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one RGB uint8 image; resolves to the uint8 mask at
        the image's own resolution.  Raises ``queue.Full`` under
        overload (``max_queue``)."""
        fut: Future = Future()
        self._enqueue(("image", np.asarray(image), fut))
        return fut

    def submit_instance(self, image: np.ndarray, box,
                        keypoints=None) -> Future:
        """Enqueue one conditioned instance request: RGB uint8 image, a
        person box (xyxy, image coordinates) and optional [17, 3]
        (x, y, vis) keypoints.  Resolves to ``{"mask", "mask_score"}``
        with the mask at the image's own resolution.  Raises
        ``queue.Full`` under overload (``max_queue``)."""
        from instancesegmentation_tpu_torch.infer.proposals import (
            instance_request_row,
        )

        fut: Future = Future()
        row, meta = instance_request_row(image, box, keypoints, self.canvas)
        self._enqueue(("instance", (row, meta), fut))
        return fut

    def predict(self, image: np.ndarray, timeout: Optional[float] = None):
        """Synchronous sugar over ``submit``."""
        return self.submit(image).result(timeout=timeout)

    def predict_instance(self, image: np.ndarray, box, keypoints=None,
                         timeout: Optional[float] = None):
        """Synchronous sugar over ``submit_instance``."""
        return self.submit_instance(image, box, keypoints).result(
            timeout=timeout
        )

    # -- worker --------------------------------------------------------
    def _collect(self):
        """Block for one request, then gather stragglers until the
        batch is full or ``max_delay`` has passed."""
        import time

        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_delay
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                # note shutdown for after this batch drains.  A flag,
                # NOT a re-put: with a bounded queue a blocking re-put
                # could deadlock against submitters that filled the
                # queue behind the sentinel
                self._sentinel_seen = True
                break
            batch.append(item)
        return batch

    @staticmethod
    def _resolve(fut: Future, value, is_error: bool) -> None:
        """Complete a future, tolerating a concurrent cancel: the
        cancelled() check alone races with client-side fut.cancel(), and
        an InvalidStateError escaping here would kill the worker thread
        and hang every other request."""
        try:
            if fut.cancelled():
                return
            if is_error:
                fut.set_exception(value)
            else:
                fut.set_result(value)
        except Exception:
            pass  # future was cancelled/completed in the race window

    def _serve_images(self, items) -> None:
        images = [p for _, p, _ in items]
        futures = [f for _, _, f in items]
        self.dispatches += 1  # counted even if the engine call raises
        try:
            masks = self.engine.predict_images(images)
            if len(masks) != len(futures):
                raise RuntimeError(
                    f"engine returned {len(masks)} masks for "
                    f"{len(futures)} requests"
                )
        except Exception as e:  # fan the failure out to this batch only
            for f in futures:
                self._resolve(f, e, is_error=True)
            return
        for f, m in zip(futures, masks):
            self._resolve(f, m, is_error=False)
        self.served += len(futures)

    def _serve_instances(self, items) -> None:
        from instancesegmentation_tpu_torch.infer.proposals import (
            finish_instance_request,
        )

        rows = [p[0] for _, p, _ in items]
        metas = [p[1] for _, p, _ in items]
        futures = [f for _, _, f in items]
        self.dispatches += 1
        try:
            batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
            probs, canvas_masks = self.engine.predict_instances(batch)
            if len(canvas_masks) != len(futures):
                raise RuntimeError(
                    f"engine returned {len(canvas_masks)} masks for "
                    f"{len(futures)} requests"
                )
        except Exception as e:
            for f in futures:
                self._resolve(f, e, is_error=True)
            return
        for i, (f, meta) in enumerate(zip(futures, metas)):
            mask, score = finish_instance_request(
                canvas_masks[i], probs[i, ..., 0], meta,
                self.engine.threshold,
            )
            self._resolve(f, {"mask": mask, "mask_score": score},
                          is_error=False)
        self.served += len(futures)

    def _serve(self, batch) -> None:
        """Dispatch one collated batch, grouped by request type (the
        two types run different fixed-shape programs)."""
        img_items = [it for it in batch if it[0] == "image"]
        inst_items = [it for it in batch if it[0] == "instance"]
        if img_items:
            self._serve_images(img_items)
        if inst_items:
            self._serve_instances(inst_items)

    def _drain_and_stop(self) -> None:
        """Shutdown sentinel seen: serve requests that raced into the
        queue behind it (submit() passed the closed check before
        close() set it) so no future is left unresolved."""
        leftovers = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                leftovers.append(item)
        for i in range(0, len(leftovers), self.max_batch):
            self._serve(leftovers[i : i + self.max_batch])

    def _worker(self):
        self._sentinel_seen = False
        while True:
            batch = self._collect()
            if batch is None:
                self._drain_and_stop()
                return
            if batch:
                self._serve(batch)
            if self._sentinel_seen:
                self._drain_and_stop()
                return
            if not batch and self._closed.is_set() and self._q.empty():
                return

    # -- lifecycle -----------------------------------------------------
    def close(self, timeout: float = 10.0) -> None:
        """Drain pending requests, then stop the worker (idempotent)."""
        with self._submit_lock:
            if not self._closed.is_set():
                self._closed.set()
                self._q.put(None)
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
