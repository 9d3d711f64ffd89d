"""Dynamic micro-batching for MODEL units.

Counterpart of ``seldon_core_tpu/graph/batching.py``. The reference
engine is strictly unary per hop; on the card a ResNet-50 forward at
batch 1 and batch 8 cost nearly the same wall-clock, so fusing concurrent
unary requests into one forward multiplies throughput at ~zero latency
cost.

Mechanics: predict() calls enqueue (array, message, future); the flusher
fires when ``max_batch`` rows are waiting or ``timeout_ms`` elapsed since
the first enqueue, concatenates along axis 0, makes ONE downstream call,
and splits the response back per caller, each piece in its caller's
request encoding. Non-batchable payloads (strData/binData/jsonData)
pass through as singletons; mismatched trailing dims fail every waiter
of the flush.

Batch sizes are bucketed to powers of two capped at ``max_batch``, so the
model sees a small, stable set of shapes (padding rows are sliced off
after the call; they do flow through the model, so batching is for PURE
predict functions). An oversized flush (one request carrying more than
``max_batch`` rows) passes through unpadded.

Device path: when the unit is an in-process :class:`TorchComponent` with
a loaded forward, each request's slab is put on the device at arrival
(through the component's own ``_to_dev``), the flush concatenates and
pads there, and the fused tensor reaches the forward under the
``__torch__`` message key. A slab whose device put fails stays on the
host, and a flush holding one fuses on the host (still computed on the
card); :attr:`MicroBatchingClient.prefetch_failures` counts those puts.
Under a serving mesh the puts land on the mesh's compute device, and a
slab that does not tile the mesh's ``data`` axis is refused there, so it
fuses on the host as in the JAX engine: a flush of such slabs padded to
a bucket that tiles ``data`` is served, and a flush of ONE such request
goes to the unit as it came and fails there as it fails in the JAX
engine (``_to_dev`` refuses it).
The puts run on the default CUDA stream from pageable memory, so each
waits behind the forward in flight: :attr:`MicroBatchingClient.h2d_seconds`
is their host wall time.

Config surface (the reference's annotations-as-feature-flags idiom,
InternalPredictionService.java:82-91): ``seldon.io/microbatch: "true"``
on a predictor turns batching on for its MODEL units, with
``seldon.io/microbatch-max-batch``, ``seldon.io/microbatch-timeout-ms``
and ``seldon.io/microbatch-pad``. Per-unit counters and the queue-depth
gauge land in the engine metrics registry (``engine_metrics.MICROBATCH_*``).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from .. import payload as payload_mod
from .client import UnitClient
from .engine_metrics import (
    MICROBATCH_FLUSHES,
    MICROBATCH_PADDED_ROWS,
    MICROBATCH_QUEUE_DEPTH,
    MICROBATCH_ROWS,
)

logger = logging.getLogger(__name__)


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


ANNOTATION_ENABLE = "seldon.io/microbatch"
ANNOTATION_MAX_BATCH = "seldon.io/microbatch-max-batch"
ANNOTATION_TIMEOUT_MS = "seldon.io/microbatch-timeout-ms"
ANNOTATION_PAD = "seldon.io/microbatch-pad"


def batching_from_annotations(spec) -> Dict[str, Dict]:
    """Per-unit batching config from predictor annotations. Returns {}
    unless ``seldon.io/microbatch`` is "true"; otherwise every MODEL unit
    in the graph gets the annotated kwargs."""
    ann = getattr(spec, "annotations", None) or {}
    if str(ann.get(ANNOTATION_ENABLE, "false")).lower() != "true":
        return {}
    kwargs: Dict[str, Any] = {}
    try:
        if ANNOTATION_MAX_BATCH in ann:
            kwargs["max_batch"] = int(ann[ANNOTATION_MAX_BATCH])
        if ANNOTATION_TIMEOUT_MS in ann:
            kwargs["timeout_ms"] = float(ann[ANNOTATION_TIMEOUT_MS])
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"bad seldon.io/microbatch-* annotation on predictor "
            f"{getattr(spec, 'name', '?')!r}: {e}"
        ) from e
    if ANNOTATION_PAD in ann:
        kwargs["pad_to_bucket"] = str(ann[ANNOTATION_PAD]).lower() == "true"

    from .spec import UnitType

    out: Dict[str, Dict] = {}

    def walk(unit):
        if unit.type in (None, UnitType.MODEL):
            out[unit.name] = dict(kwargs)
        for child in unit.children:
            walk(child)

    walk(spec.graph)
    return out


class MicroBatchingClient(UnitClient):
    def __init__(
        self,
        inner: UnitClient,
        max_batch: int = 32,
        timeout_ms: float = 2.0,
        pad_to_bucket: bool = True,
        metrics=None,
        unit: str = "",
    ):
        self.inner = inner
        self.max_batch = max_batch
        self.timeout_s = timeout_ms / 1000.0
        self.pad_to_bucket = pad_to_bucket
        self.metrics = metrics
        self._labels = {"unit": unit or "model"}
        self._queue: List[Tuple[Any, Dict, asyncio.Future]] = []
        self._flusher: Optional[asyncio.Task] = None
        self._flushes: Set[asyncio.Task] = set()
        self._lock = asyncio.Lock()
        self._device_path: Optional[bool] = None  # lazily probed, sticky True
        self._pad_cache: Dict[Tuple, Any] = {}  # (rows, trailing, dtype, device) -> zeros
        # device puts that failed (their flushes fuse on the host), and the
        # host wall time and count of the puts made
        self.prefetch_failures = 0
        self.h2d_seconds = 0.0
        self.h2d_puts = 0
        self._put_lock = threading.Lock()

    def _gauge_depth(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge_set(
                MICROBATCH_QUEUE_DEPTH,
                float(sum(a.shape[0] for a, _, _ in self._queue)),
                self._labels,
            )

    def _count(self, name: str, value: float = 1.0) -> None:
        if self.metrics is not None:
            self.metrics.counter_inc(name, self._labels, value)

    def _use_device_path(self) -> bool:
        """Probe (once true, sticky) whether the inner unit takes device
        tensors in-process. Not cached while False: the component may not
        have loaded yet at the first requests."""
        if self._device_path:
            return True
        probe = getattr(self.inner, "accepts_device_arrays", None)
        if probe is not None and probe():
            self._device_path = True
            return True
        return False

    def _device_put(self, arr):
        t0 = time.perf_counter()
        out = self.inner.device_put(arr)
        with self._put_lock:
            self.h2d_seconds += time.perf_counter() - t0
            self.h2d_puts += 1
        return out

    def _spawn(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._flushes.add(task)
        task.add_done_callback(self._flushes.discard)

    async def call(self, method: str, message: Dict[str, Any]) -> Dict[str, Any]:
        if method != "predict":
            return await self.inner.call(method, message)
        data = message.get("data")
        if not data:
            return await self.inner.call(method, message)
        loop = asyncio.get_running_loop()
        try:
            # decode off the event loop: unpacking a 32-image request is
            # milliseconds of host CPU that would stall every other request
            arr = await loop.run_in_executor(None, payload_mod.json_data_to_array, data)
        except payload_mod.PayloadError:
            return await self.inner.call(method, message)
        if arr.ndim < 2:
            arr = arr.reshape(1, -1)
        if self._use_device_path():
            # put this slab on the device now, while earlier batches run
            try:
                arr = await loop.run_in_executor(None, self._device_put, arr)
            except Exception:  # noqa: BLE001 - fall back to the host fuse
                self.prefetch_failures += 1
                logger.warning("device put failed; this slab fuses on the host",
                               exc_info=True)

        fut: asyncio.Future = loop.create_future()
        async with self._lock:
            self._queue.append((arr, message, fut))
            n_rows = sum(a.shape[0] for a, _, _ in self._queue)
            self._gauge_depth()
            if n_rows >= self.max_batch:
                self._launch_flush()
            elif self._flusher is None or self._flusher.done():
                self._flusher = asyncio.ensure_future(self._delayed_flush())
        return await fut

    def _launch_flush(self):
        batch, self._queue = self._queue, []
        self._gauge_depth()
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None
        self._spawn(self._flush(batch))

    async def _delayed_flush(self):
        try:
            await asyncio.sleep(self.timeout_s)
        except asyncio.CancelledError:
            return
        async with self._lock:
            if self._queue:
                batch, self._queue = self._queue, []
                self._gauge_depth()
                self._spawn(self._flush(batch))

    def _dev_pad(self, rows: int, trailing, dtype, device):
        import torch

        key = (rows, tuple(trailing), dtype, device)
        pad = self._pad_cache.get(key)
        if pad is None:
            pad = torch.zeros((rows, *trailing), dtype=dtype, device=device)
            self._pad_cache[key] = pad
        return pad

    def _fuse_device(self, arrays, rows: int):
        """Concatenate device-resident slabs (+ bucket padding) on the
        device, on the default stream after the puts that made them."""
        import torch

        fused = torch.cat(arrays, dim=0) if len(arrays) > 1 else arrays[0]
        if self.pad_to_bucket and rows <= self.max_batch:
            padded_rows = _bucket(rows, self.max_batch)
            if padded_rows > rows:
                pad = self._dev_pad(padded_rows - rows, fused.shape[1:], fused.dtype,
                                    fused.device)
                fused = torch.cat([fused, pad], dim=0)
                self._count(MICROBATCH_PADDED_ROWS, float(padded_rows - rows))
        return fused

    def _fuse_host(self, arrays, rows: int) -> np.ndarray:
        arrays = [payload_mod._to_numpy(a) for a in arrays]
        try:
            dtype = np.result_type(*(a.dtype for a in arrays))
        except TypeError:
            # extended dtypes (a bf16 slab from a partial prefetch) have no
            # numpy promotion rule against the others
            dtype = np.dtype(np.float32)
        fused = np.concatenate([a.astype(dtype, copy=False) for a in arrays], axis=0)
        if self.pad_to_bucket and rows <= self.max_batch:
            # padding is capped at max_batch; an oversized flush passes
            # through unpadded
            padded_rows = _bucket(rows, self.max_batch)
            if padded_rows > rows:
                pad = np.zeros((padded_rows - rows, *fused.shape[1:]), dtype=fused.dtype)
                fused = np.concatenate([fused, pad], axis=0)
                self._count(MICROBATCH_PADDED_ROWS, float(padded_rows - rows))
        return fused

    async def _flush(self, batch):
        if not batch:
            return
        # the device path only when EVERY slab made it to the device: a
        # mixed batch (one put failed, or a request raced the load) fuses
        # whole on the host
        device_batch = all(not isinstance(a, np.ndarray) for a, _, _ in batch)
        if len(batch) == 1 and not device_batch:
            arr, message, fut = batch[0]
            try:
                result = await self.inner.call("predict", message)
                if not fut.done():
                    fut.set_result(result)
            except Exception as e:  # noqa: BLE001
                if not fut.done():
                    fut.set_exception(e)
            return
        try:
            arrays = [a for a, _, _ in batch]
            trailing = {tuple(a.shape[1:]) for a in arrays}
            if len(trailing) != 1:
                raise ValueError(f"mismatched feature shapes {sorted(map(str, trailing))}")
            rows = sum(a.shape[0] for a in arrays)
            self._count(MICROBATCH_FLUSHES)
            self._count(MICROBATCH_ROWS, float(rows))
            names = (batch[0][1].get("data") or {}).get("names", [])
            loop = asyncio.get_running_loop()
            if device_batch:
                # singleton flushes take this path too: the slab is already
                # on the device, re-sending the wire message would decode twice
                fused = await loop.run_in_executor(None, self._fuse_device, arrays, rows)
                fused_msg = {"data": {payload_mod.DEVICE_KEY: fused, "names": list(names)}}
            else:
                fused = await loop.run_in_executor(None, self._fuse_host, arrays, rows)
                # raw keeps bytes end to end on the fused hop for every
                # numeric dtype, bf16/fp8 included; ndarray would round-trip
                # through Python lists (and upcast the extended dtypes)
                enc = (
                    "raw"
                    if fused.dtype.kind in "fiub" or payload_mod.is_extended_dtype(fused.dtype)
                    else "ndarray"
                )
                fused_msg = {"data": payload_mod.array_to_json_data(fused, names, enc)}
            meta = batch[0][1].get("meta")
            if meta:
                fused_msg["meta"] = meta
            response = await self.inner.call("predict", fused_msg)
            out_data = response.get("data")
            if out_data is None:
                raise ValueError("batched predict returned no data")
            out = payload_mod.json_data_to_array(out_data)
            if out.shape[0] < rows:
                raise ValueError(
                    f"batched predict returned {out.shape[0]} rows for {rows} inputs"
                )
            out_names = out_data.get("names", [])
            out_enc = next((k for k in payload_mod.TENSOR_KEYS if k in out_data), "ndarray")
            offset = 0
            for arr, message, fut in batch:
                n = arr.shape[0]
                piece = out[offset: offset + n]
                offset += n
                resp_i = dict(response)
                # each caller gets its piece back in ITS request encoding
                # (a JSON ndarray client must not see raw bytes just because
                # the fused hop ran binary)
                req_data = message.get("data") or {}
                enc_i = payload_mod.effective_encoding(
                    piece,
                    next((k for k in payload_mod.TENSOR_KEYS if k in req_data), out_enc),
                )
                resp_i["data"] = payload_mod.array_to_json_data(piece, out_names, enc_i)
                if not fut.done():
                    fut.set_result(resp_i)
        except Exception as e:  # noqa: BLE001 - fail every waiter
            logger.warning("micro-batch flush failed, failing %d reqs: %s", len(batch), e)
            for _, _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)

    async def ready(self) -> bool:
        return await self.inner.ready()

    async def close(self) -> None:
        if self._flusher is not None:
            self._flusher.cancel()
        await self.inner.close()
