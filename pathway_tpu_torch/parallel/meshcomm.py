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

Across processes (``spawn -n M`` with ``PATHWAY_MESH_EXCHANGE=1``),
:class:`MultiHostMeshComm` wraps the host ``ClusterComm``: one card a
process, all of that process's workers on it. Per channel-tick its workers
allgather their control tuples over the cluster, each process's leader packs
its workers' dense rows into pinned staging and buckets them on its card
for every worker of the cluster (one ``bucket_exchange`` launch), and the
leaders swap the per-process slices with ``all_to_all_single`` at uneven
splits, the counts known from the allgather. The swap's transport is chosen
once, at construction, from the placement: NCCL when every process has a
card of its own, else the gloo group over pinned host buffers (processes
that share a card, and every CPU run). Nothing switches transport later.

Copy of ``pathway_tpu/parallel/meshcomm.py`` (``MeshComm`` and
``MultiHostMeshComm``) with the protocol unchanged and the async plane's
delegation, on a torch device instead of a JAX mesh; ``MeshComm`` also
delegates ``async_congested``, which the reference's leaves at the base
class's ``False``. Where the reference's multi-host collective needs one
device a worker and a ``jax.distributed`` mesh, the port's needs one card a
process and a ``torch.distributed`` group.

Reference being replaced: timely's ``zero_copy`` allocator
(``external/timely-dataflow/communication/src/allocator/zero_copy/``).
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..engine.delta import Delta, concat_deltas
from ..engine.mesh_exchange import (
    HOST,
    MeshExchangeRunner,
    _pow2,
    agree_kinds,
    local_signature,
)
from .comm import Comm

__all__ = ["MeshComm", "MultiHostMeshComm", "choose_transport"]

_log = logging.getLogger(__name__)


class _HostDelegate(Comm):
    """What both mesh comms take from their host ``inner`` comm: the
    control plane, non-delta payloads and the async (frontier-driven) plane.
    The device collective is bulk-synchronous, so ``PATHWAY_ASYNC_EXEC=1``
    with mesh exchange routes record exchange over the host plane."""

    inner: Comm
    runner: MeshExchangeRunner
    #: the prefix of the flow ids this comm's tracer spans carry
    _flow_prefix: str

    def _init_tracing(self) -> None:
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
            f"{self._flow_prefix}{channel}", f"t{tick}", f"{phase}{worker}",
        )

    def exchange(self, channel, tick, worker_id, buckets):
        return self.inner.exchange(channel, tick, worker_id, buckets)

    def allgather(self, tag, worker_id, obj):
        return self.inner.allgather(tag, worker_id, obj)

    def barrier(self, worker_id: int):
        self.inner.barrier(worker_id)

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


def _deposit(buckets: Sequence[Delta | None], column_names: list[str],
             n: int) -> tuple:
    """A worker's buckets as one deposit: (the non-empty (destination,
    Delta) parts, their rows concatenated, each row's destination, the rows
    a destination, the dtype signature)."""
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
    return parts, local, dest, counts, local_signature(local, column_names)


class MeshComm(_HostDelegate):
    """``inner``'s host collectives plus the record exchange on ``device``
    (the card unless the caller passes ``device="cpu"``), where every
    worker's shard lives."""

    _flow_prefix = "mx"

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
        self._init_tracing()

    def abort(self):
        self.inner.abort()

    def close(self):
        # the final tick's slots have no successor tick to reclaim them
        with self._slot_lock:
            self._slots.clear()
        self.inner.close()

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
        parts, local, dest, counts, sig = _deposit(buckets, column_names, n)

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


def choose_transport(device_type: str, placements: list[tuple[str, str]]) -> str:
    """The swap's transport for processes at ``placements`` (each (host, card) of a process):
    ``"nccl"`` when the processes run on cards and no two share one, else ``"gloo"``. NCCL
    refuses two ranks of one communicator on one card, and a CPU run has none."""
    if device_type == "cuda" and len(set(placements)) == len(placements):
        return "nccl"
    return "gloo"


def _card_id(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    return str(uuid) if uuid is not None else f"cuda:{device.index}"


class MultiHostMeshComm(_HostDelegate):
    """Cross-process mesh exchange over the host ``ClusterComm`` ``inner``.

    Processes each own ``threads`` workers (worker ``p*threads + t`` is
    thread ``t`` of process ``p``) and one card, ``device`` (the card
    ``process_id`` modulo the cards the process sees, unless the caller
    names one, or ``"cpu"``). Per channel-tick:

    1. every worker allgathers its tiny control tuple (dtype signature,
       per-destination counts) over ``inner``, and deposits its local Delta
       in a PROCESS-local slot;
    2. each process's leader thread packs its workers' dense rows into
       pinned staging, uploads it, buckets it for every worker of the
       cluster with one ``bucket_exchange`` launch, and swaps the
       per-process slices with the other leaders through
       ``all_to_all_single`` at uneven splits (the counts come from the
       allgather, and the kernel's are held against them);
    3. every worker unpacks its arrived rows; object/string columns swap
       over ``inner`` and re-zip by source order.

    The swap runs on the default ``torch.distributed`` group (created here
    over gloo from ``PATHWAY_*``, as ``parallel/distributed.py`` reads it,
    when none exists) or on an NCCL group beside it, as
    :func:`choose_transport` decides from every process's placement.

    Reference: timely's cluster allocator
    (``communication/src/allocator/zero_copy/``) + bootstrap
    (``communication/src/initialize.rs``).
    """

    _flow_prefix = "mxh"

    def __init__(self, inner: Comm, process_id: int, n_processes: int,
                 threads: int, device: str | torch.device = "cuda"):
        self.inner = inner
        self.n_workers = inner.n_workers
        self.process_id = process_id
        self.n_processes = n_processes
        self.threads = threads
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        self.device = dev
        self.runner = MeshExchangeRunner(self.n_workers, dev)
        self._owns_default_group = not dist.is_initialized()
        if self._owns_default_group:
            from .distributed import init_from_env

            init_from_env(device=dev.type, backend="gloo")
        if dist.get_world_size() != n_processes:
            raise RuntimeError(
                f"mesh exchange: the process group has {dist.get_world_size()} "
                f"ranks for {n_processes} processes"
            )
        placements: list[Any] = [None] * n_processes
        dist.all_gather_object(placements, (socket.gethostname(), _card_id(dev)))
        #: the swap's transport, fixed for this comm's life
        self.transport = choose_transport(dev.type, placements)
        if self.transport == "nccl":
            self._group = dist.new_group(backend="nccl")
        elif dist.get_backend() == "gloo":
            self._group = None  # the default group
        else:
            self._group = dist.new_group(backend="gloo")
        _log.info(
            "mesh exchange on %s, process %d of %d: %s swap (placements %s)",
            dev, process_id, n_processes, self.transport, placements,
        )
        self._pinned: dict[str, torch.Tensor] = {}
        # process-local coordination among this process's worker threads
        self._local_barrier = threading.Barrier(threads)
        self._slot_lock = threading.Lock()
        self._slots: dict[tuple, dict] = {}
        # local deposit→leader flows (cross-process linkage rides the inner
        # ClusterComm's frame contexts)
        self._init_tracing()

    def abort(self):
        self._local_barrier.abort()
        self.inner.abort()

    def close(self):
        with self._slot_lock:
            self._slots.clear()
        self.inner.close()
        if self._owns_default_group and dist.is_initialized():
            dist.destroy_process_group()

    def comm_stats(self) -> dict[str, float]:
        return {**super().comm_stats(),
                "mesh_swap_nccl": float(self.transport == "nccl")}

    def _local_index(self, worker_id: int) -> int:
        return worker_id - self.process_id * self.threads

    def exchange_deltas(
        self,
        channel: int,
        tick: int,
        worker_id: int,
        buckets: Sequence[Delta | None],
        column_names: list[str],
    ) -> list[Delta]:
        n = self.n_workers
        parts, local, dest, counts, sig = _deposit(buckets, column_names, n)

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
            slot = self._slots.setdefault(
                key, {"payloads": [None] * self.threads}
            )
            slot["payloads"][self._local_index(worker_id)] = (local, dest)
        # ONE global control allgather per channel-tick
        metas = self.inner.allgather(
            ("mxh", channel, tick), worker_id, (sig, counts.tolist())
        )
        total = sum(sum(m[1]) for m in metas)
        kinds = agree_kinds([m[0] for m in metas], len(column_names))
        cap_in = _pow2(max(sum(m[1]) for m in metas)) if total else 8
        cap_bucket = _pow2(max(max(m[1]) for m in metas)) if total else 8

        try:
            self._local_barrier.wait()  # all local deposits visible
            leader = self._local_index(worker_id) == 0
            if leader:
                with self._slot_lock:
                    stale = [k for k in self._slots if k[1] < tick]
                    for k in stale:
                        del self._slots[k]
                    slot = self._slots[key]
                try:
                    sent = np.array([m[1] for m in metas], dtype=np.int64)
                    if total:
                        # count only THIS process's deposited rows — every
                        # leader runs this block, so recording the global
                        # total would inflate the fleet sum n_processes×
                        base = self.process_id * self.threads
                        self.runner.note_collective(
                            int(sent[base:base + self.threads].sum())
                        )
                    slot["result"] = (
                        self._run_collective(
                            slot["payloads"], column_names, kinds,
                            cap_in, cap_bucket, sent,
                        )
                        if total
                        else None
                    )
                    if tracer is not None:
                        base = self.process_id * self.threads
                        for w in range(base, base + self.threads):
                            tracer.flow_end(
                                "mesh.deposit",
                                self._flow_id(channel, tick, w, "in"),
                            )
                            tracer.flow_start(
                                "mesh.result",
                                self._flow_id(channel, tick, w, "out"),
                            )
                except BaseException as e:  # noqa: BLE001
                    slot["result"] = _DriverError(e)
                    self._local_barrier.wait()
                    raise
                self._local_barrier.wait()
            else:
                self._local_barrier.wait()
                slot = self._slots[key]
        except threading.BrokenBarrierError:
            raise RuntimeError(
                "a peer worker failed — aborting mesh exchange"
            ) from None

        result = slot["result"]
        if isinstance(result, _DriverError):
            raise RuntimeError(
                "mesh exchange failed on the process leader"
            ) from result.error
        if tracer is not None:
            tracer.flow_end(
                "mesh.result", self._flow_id(channel, tick, worker_id, "out")
            )

        host_names = [c for c, k in zip(column_names, kinds) if k == HOST]
        host_cols: dict[int, dict[str, np.ndarray]] = {}
        if host_names and total:
            obj_buckets: list[Any] = [None] * n
            if parts:
                per_dst: dict[int, dict[str, list]] = {}
                for dst, d in parts:
                    cols = per_dst.setdefault(dst, {c: [] for c in host_names})
                    for c in host_names:
                        cols[c].append(d.data[c])
                for dst, cols in per_dst.items():
                    obj_buckets[dst] = (
                        worker_id,
                        {c: np.concatenate(v) for c, v in cols.items()},
                    )
            received = self.inner.exchange(
                ("mxh-obj", channel), tick, worker_id, obj_buckets
            )
            for src, cols in received:
                host_cols[src] = cols

        if result is None:
            return []
        rows, arrived = result
        li = self._local_index(worker_id)
        return self.runner.unpack_arrivals(
            rows=rows[li],
            arrived=arrived[li],
            kinds=kinds,
            column_names=column_names,
            host_cols=host_cols,
        )

    def _host(self, name: str, rows: int, width: int) -> torch.Tensor:
        """A host buffer of ``[rows, width]`` int32 words kept under ``name``
        (pinned on the card), grown to a power of two and reused."""
        buf = self._pinned.get(name)
        if buf is None or buf.numel() < rows * width:
            buf = self._pinned[name] = torch.empty(
                _pow2(max(rows * width, 1)), dtype=torch.int32,
                pin_memory=self.device.type == "cuda",
            )
        return buf[: rows * width].view(rows, width)

    def _run_collective(self, payloads, column_names, kinds, cap_in,
                        cap_bucket, sent):
        """Leader thread: bucket THIS process's workers' rows for every
        worker of the cluster on the card, then swap the per-process slices
        with every other process's leader. ``sent`` is the cluster's
        ``[source, destination]`` row counts from the allgather. Returns
        (rows, arrived) for this process's workers: ``rows[t]`` the rows that
        arrived at local worker ``t``, source-major, uint32 on the host, and
        ``arrived[t]`` the count from each source."""
        import time as _time

        from . import exchange

        tracer = self._tracer
        t0 = _time.perf_counter_ns()
        n, t, P = self.n_workers, self.threads, self.n_processes
        base = self.process_id * t
        cuda = self.device.type == "cuda"
        width = self.runner.width(kinds)
        stage = self.runner.pack_blocks(
            list(payloads), kinds, column_names, cap_in
        )
        t1 = _time.perf_counter_ns()
        if cuda:
            stage.dev.copy_(stage.host, non_blocking=True)
            stage.uploaded = torch.cuda.Event()
            stage.uploaded.record()
        rows_in = t * cap_in
        out, _, counts = exchange.bucket_exchange(
            stage.dev[: rows_in * width].view(t, cap_in, width),
            stage.dev[rows_in * width:].view(t, cap_in), n, cap_bucket,
            return_counts=True,
        )
        mine = sent[base:base + t].T  # [destination, local source]
        counts = counts.cpu().numpy().astype(np.int64)
        if not np.array_equal(counts, mine):
            raise RuntimeError(
                "mesh exchange: the buckets' counts differ from the rows sent"
            )
        # the send buffer: for each destination (process-major), each local
        # source's first counts[d, s] slots of its bucket
        slot = (np.arange(n)[:, None] * (t * cap_bucket)
                + np.arange(t)[None, :] * cap_bucket)
        idx = np.concatenate([
            slot[d, s] + np.arange(c)
            for d in range(n) for s in range(t) if (c := int(counts[d, s]))
        ] or [np.empty(0, dtype=np.int64)])
        send_splits = [int(counts[q * t:(q + 1) * t].sum()) for q in range(P)]
        # from process p: its sources' rows for each of my workers, worker-major
        recv_counts = [sent[p * t:(p + 1) * t, base:base + t] for p in range(P)]
        recv_splits = [int(c.sum()) for c in recv_counts]
        send = out.view(-1, width).index_select(
            0, torch.from_numpy(idx).to(out.device)
        )
        t2 = _time.perf_counter_ns()
        n_recv = sum(recv_splits)
        if self.transport == "nccl":
            recv = torch.empty((n_recv, width), dtype=torch.int32,
                               device=self.device)
            dist.all_to_all_single(recv, send, recv_splits, send_splits,
                                   group=self._group)
            host = self._host("recv", n_recv, width)
            host.copy_(recv, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        else:
            if cuda:
                send_host = self._host("send", send.shape[0], width)
                send_host.copy_(send, non_blocking=True)
                torch.cuda.current_stream(self.device).synchronize()
                send = send_host
            host = self._host("recv", n_recv, width)
            dist.all_to_all_single(host, send, recv_splits, send_splits,
                                   group=self._group)
        t3 = _time.perf_counter_ns()
        words = host.numpy().view(np.uint32)
        rows, arrived = [], []
        # in p's block: my worker j's rows from each of p's sources, in order
        at = np.cumsum([0] + recv_splits)
        offsets = [at[p] + np.concatenate([[0], np.cumsum(recv_counts[p].sum(0))])
                   for p in range(P)]
        for j in range(t):
            pieces = [words[offsets[p][j]:offsets[p][j + 1]] for p in range(P)]
            rows.append(np.concatenate(pieces) if pieces else
                        np.empty((0, width), dtype=np.uint32))
            arrived.append(sent[:, base + j].copy())
        t4 = _time.perf_counter_ns()
        # the upload rides the kernel's wait here; the swap is its own step
        for step, ns in (("pack", t1 - t0), ("kernel", t2 - t1),
                         ("swap", t3 - t2), ("readback", t4 - t3)):
            self.runner.step_ns[step] = self.runner.step_ns.get(step, 0) + ns
        if tracer is not None:
            tracer.complete(
                "mesh.collective",
                t0,
                {"cap_in": cap_in, "cap_bucket": cap_bucket,
                 "process": self.process_id, "transport": self.transport},
            )
        return rows, arrived
