"""MeshComm — the device communication backend for the sharded dataflow.

Wraps a host :class:`~pathway_tpu_torch.parallel.comm.Comm` (LocalComm threads)
and routes the dense numeric part of every Exchange frame through the
bucketed all-to-all on one card (``engine/mesh_exchange.py`` →
``parallel/exchange.py``, the ``bucket_exchange`` kernel), so the record
bytes move on the device instead of host memory. Object/string columns
ride the shared deposit and are re-zipped by source order.

Per tick + exchange channel, the protocol is:

1. every worker deposits (signature, per-destination counts, its local
   Delta by reference, destination array) into a shared slot and hits ONE
   barrier;
2. the driver thread (worker 0) agrees dtype kinds + power-of-two caps,
   packs ALL workers' dense rows into one pinned staging buffer, uploads
   it with one non-blocking copy, runs the bucketing kernel, brings its
   per-(destination, source) counts back inside the wait, copies only the
   rows that arrived into each destination worker's pinned buffer, waits,
   and publishes the result; second barrier;
3. every worker unpacks its arrived rows and re-zips any host-path
   (object) columns straight from the deposited Deltas.

Total host synchronization: 2 barriers per channel-tick.

The device collective is bulk-synchronous by construction, so a sharded
streaming run over ``MeshComm`` keeps the BSP loop unless
``PATHWAY_ASYNC_EXEC=1``; then record exchange posts through the inner
``LocalComm``'s async plane and this class's device path stays idle.

Copy of ``pathway_tpu/parallel/meshcomm.py``'s ``MeshComm`` with the
protocol unchanged and its async plane's delegation, on a torch device
instead of a JAX mesh; it also delegates ``async_congested``, which the
reference's leaves at the base class's ``False``. ``MultiHostMeshComm`` (a
collective across processes) is left out.

Reference being replaced: timely's ``zero_copy`` allocator
(``external/timely-dataflow/communication/src/allocator/zero_copy/``).
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..engine.delta import Delta, concat_deltas
from ..engine.mesh_exchange import (
    HOST,
    MeshExchangeRunner,
    local_signature,
)
from .comm import Comm

__all__ = ["MeshComm"]


class MeshComm(Comm):
    """``inner``'s host collectives plus the record exchange on ``device``
    (the card unless the caller passes ``device="cpu"``), where every
    worker's shard lives."""

    def __init__(self, inner: Comm, device: str | torch.device = "cuda"):
        self.inner = inner
        self.n_workers = inner.n_workers
        self.device = resolve_device(device)
        self.runner = MeshExchangeRunner(self.n_workers, self.device)
        # (channel, tick) -> {"payloads": [...], "result": ...}; entries for
        # a channel are deleted by the driver at the NEXT tick's compute
        # phase, when the post-deposit barrier proves no reader remains
        self._slots: dict[tuple, dict] = {}
        self._slot_lock = threading.Lock()
        # tracing: link every worker's deposit to the driver's collective
        # and the collective back to each worker's readback (flow events
        # with deterministic ids — one shared tracer, no context to ship)
        from ..internals.tracing import get_tracer, mint_flow_tag

        self._tracer = get_tracer()
        self._flow_tag = mint_flow_tag()

    def _flow_id(self, channel: int, tick: int, worker: int,
                 phase: str) -> str:
        from ..internals.tracing import make_flow_id

        return make_flow_id(
            self._tracer, self._flow_tag,
            f"mx{channel}", f"t{tick}", f"{phase}{worker}",
        )

    # host-comm delegation (control plane + non-delta payloads)

    def exchange(self, channel, tick, worker_id, buckets):
        return self.inner.exchange(channel, tick, worker_id, buckets)

    def allgather(self, tag, worker_id, obj):
        return self.inner.allgather(tag, worker_id, obj)

    def barrier(self, worker_id: int):
        self.inner.barrier(worker_id)

    def abort(self):
        self.inner.abort()

    def close(self):
        # the final tick's slots have no successor tick to reclaim them
        with self._slot_lock:
            self._slots.clear()
        self.inner.close()

    # async (frontier-driven) plane: host-path delegation — the device
    # collective is inherently bulk-synchronous, so PATHWAY_ASYNC_EXEC=1
    # with mesh exchange routes record exchange over the host plane
    def supports_async(self) -> bool:
        return self.inner.supports_async()

    def async_attach(self, worker_id, waker):
        self.inner.async_attach(worker_id, waker)

    def async_post_exchange(self, worker_id, channel, time, buckets,
                            ingest_ns=None, seq=None, enq_ns=None):
        return self.inner.async_post_exchange(
            worker_id, channel, time, buckets, ingest_ns, seq, enq_ns
        )

    def async_broadcast(self, worker_id, payload):
        self.inner.async_broadcast(worker_id, payload)

    def async_drain(self, worker_id):
        return self.inner.async_drain(worker_id)

    def async_congested(self, worker_id):
        return self.inner.async_congested(worker_id)

    def comm_stats(self) -> dict[str, float]:
        out = dict(self.inner.comm_stats())
        out["mesh_pending_slots"] = float(len(self._slots))
        out.update(self.runner.stats())
        return out

    # the device data plane

    def exchange_deltas(
        self,
        channel: int,
        tick: int,
        worker_id: int,
        buckets: Sequence[Delta | None],
        column_names: list[str],
    ) -> list[Delta]:
        """All-to-all of columnar Delta buckets; dense columns on the
        device, object columns re-zipped from the shared deposit."""
        n = self.n_workers
        parts = [
            (dst, d) for dst, d in enumerate(buckets) if d is not None and len(d)
        ]
        local = concat_deltas([d for _, d in parts], column_names) if parts else None
        dest = (
            np.concatenate(
                [np.full(len(d), dst, dtype=np.int32) for dst, d in parts]
            )
            if parts
            else np.empty(0, dtype=np.int32)
        )
        counts = np.zeros(n, dtype=np.int64)
        for dst, d in parts:
            counts[dst] += len(d)
        sig = local_signature(local, column_names)

        key = (channel, tick)
        tracer = self._tracer
        if tracer is not None:
            tracer.flow_start(
                "mesh.deposit",
                self._flow_id(channel, tick, worker_id, "in"),
                channel=channel,
                tick=tick,
            )
        with self._slot_lock:
            slot = self._slots.setdefault(key, {"payloads": [None] * n})
            slot["payloads"][worker_id] = (sig, counts, local, dest)
        self.inner.barrier(worker_id)  # all deposits visible

        if worker_id == 0:
            with self._slot_lock:
                # all workers deposited (channel, tick) → every worker has
                # finished all earlier ticks on EVERY channel (the sweep is
                # sequential per worker); reclaim all older slots
                stale = [k for k in self._slots if k[1] < tick]
                for k in stale:
                    del self._slots[k]
                slot = self._slots[key]
            try:
                slot["result"] = self.runner.run_tick(
                    slot["payloads"], column_names
                )
                if tracer is not None:
                    # the driver's collective consumed every deposit and
                    # fans the result back out — close/open the flows here,
                    # inside the driver's tick slice
                    for w in range(n):
                        tracer.flow_end(
                            "mesh.deposit",
                            self._flow_id(channel, tick, w, "in"),
                        )
                        tracer.flow_start(
                            "mesh.result",
                            self._flow_id(channel, tick, w, "out"),
                        )
            except BaseException as e:  # noqa: BLE001 — re-raised on peers
                slot["result"] = _DriverError(e)
                self.inner.barrier(worker_id)
                raise
            self.inner.barrier(worker_id)
        else:
            self.inner.barrier(worker_id)
            slot = self._slots[key]

        result = slot["result"]
        if isinstance(result, _DriverError):
            raise RuntimeError(
                "mesh exchange failed on the driver worker"
            ) from result.error
        if tracer is not None:
            tracer.flow_end(
                "mesh.result", self._flow_id(channel, tick, worker_id, "out")
            )
        if result is None:
            return []
        kinds, _, rows, arrived = result

        host_cols: dict[int, dict[str, np.ndarray]] = {}
        host_names = [c for c, k in zip(column_names, kinds) if k == HOST]
        if host_names:
            for src, payload in enumerate(slot["payloads"]):
                _, _, src_local, src_dest = payload
                if src_local is None or not len(src_local):
                    continue
                mine = src_dest == worker_id
                if mine.any():
                    ix = np.flatnonzero(mine)
                    host_cols[src] = {
                        c: src_local.data[c][ix] for c in host_names
                    }

        return self.runner.unpack_arrivals(
            rows=rows[worker_id],
            arrived=arrived[worker_id],
            kinds=kinds,
            column_names=column_names,
            host_cols=host_cols,
        )


class _DriverError:
    """Marks a failed driver tick so peers re-raise instead of hanging."""

    def __init__(self, error: BaseException):
        self.error = error

