"""Dense-column record exchange on the card: the driver's pack, upload, bucketing and readback.

The host Exchange path (``parallel/comm.py``) hands whole column batches between worker
threads; here the dense numeric part of every frame — row keys, diffs and every numeric column —
is packed to a matrix of 32-bit words and routed through ``bucketed_all_to_all``
(``parallel/exchange.py``, the ``bucket_exchange`` kernel), so the record bytes move on the card.
Object/string columns ride the host deposit alongside and are re-zipped with the dense arrivals
by (source worker, emission order) — an ordering both paths preserve (the kernel takes slots by
running count in source order; host selection keeps source row order).

Reference being replaced: the timely ``zero_copy`` allocator
(``external/timely-dataflow/communication/src/allocator/zero_copy/``) + shard-by-key-low-bits
routing (``src/engine/value.rs:38,75``).

Packing uses 32-bit word *pairs* per 8-byte value, as the JAX package does for its x64-less
TPUs; here it keeps the kernel to one word type, and the bits of 64-bit keys, negative diffs and
NaN floats come back unchanged.

Protocol cost per channel and tick: ONE driver-side pack of every worker's rows into a pinned
staging buffer (values and destinations in one allocation), ONE non-blocking upload, one launch
of the bucketing kernel, ONE small copy of its per-(destination, source) counts inside the
driver's wait, then the readback of only the rows that arrived (the head of each source bucket)
into each destination worker's pinned buffer, reused across ticks, and one more wait; nothing is
copied for a worker with no arrivals. The driver issues the row copies while the peers wait at
the barrier: eight threads each issuing their own would trade the interpreter's lock on every
call.

Copy of ``pathway_tpu/engine/mesh_exchange.py`` (``local_signature``, ``agree_kinds``,
``_pack_words`` / ``_unpack_words``, ``MeshExchangeRunner``) with the device collective on
torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .delta import Delta

__all__ = [
    "local_signature",
    "agree_kinds",
    "MeshExchangeRunner",
    "HOST",
]

#: sentinel for "this column travels on the host path"
HOST = "O"

_CANON = {"i": np.int64, "u": np.uint64, "f": np.float64, "b": np.uint64}


def local_signature(delta: Delta | None, column_names: list[str]) -> tuple | None:
    """Per-column dtype kind ('i'/'u'/'f'/'b') or HOST, or None when this
    worker has no rows this tick (no opinion — a wildcard in agreement)."""
    if delta is None or not len(delta):
        return None
    return tuple(
        k if (k := delta.data[c].dtype.kind) in _CANON else HOST
        for c in column_names
    )


def agree_kinds(signatures: list[tuple | None], n_cols: int) -> list[str]:
    """Meet of all workers' signatures: a column is dense only when every
    contributing worker agrees on its dtype kind; any mismatch → HOST."""
    agreed: list[str | None] = [None] * n_cols
    for sig in signatures:
        if sig is None:
            continue
        for i, k in enumerate(sig):
            if agreed[i] is None:
                agreed[i] = k
            elif agreed[i] != k:
                agreed[i] = HOST
    return [a if a is not None else HOST for a in agreed]


def _pow2(n: int, floor: int = 8) -> int:
    cap = floor
    while cap < n:
        cap *= 2
    return cap


def _pack_words(arr: np.ndarray, kind: str) -> np.ndarray:
    """One dense column → [n, 2] uint32 words (the value's bits)."""
    canon = np.ascontiguousarray(arr.astype(_CANON[kind], copy=False))
    return canon.view(np.uint32).reshape(len(arr), 2)


def _unpack_words(words: np.ndarray, kind: str) -> np.ndarray:
    # a copy, always: the words lie in a readback buffer that the next tick overwrites
    raw = np.array(words, order="C").view(_CANON[kind]).reshape(-1)
    if kind == "b":
        return raw != 0
    return raw


class _Staging:
    """One pinned host buffer holding a tick's packed words and destinations (so the upload is
    one copy), its device twin, and the event that marks the upload of its contents done."""

    def __init__(self, rows: int, width: int, device: torch.device):
        pin = device.type == "cuda"
        self.host = torch.zeros(rows * (width + 1), dtype=torch.int32, pin_memory=pin)
        flat = self.host.numpy()
        self.vals = flat[: rows * width].view(np.uint32).reshape(rows, width)
        self.dst = flat[rows * width:]
        self.dev = self.host if device.type == "cpu" else torch.empty_like(self.host,
                                                                           device=device)
        self.uploaded: torch.cuda.Event | None = None


class MeshExchangeRunner:
    """Driver-side packing + the device collective, and each worker's readback.

    One instance per MeshComm. The staging buffers are cached per
    (blocks, cap_in, width) shape class; caps are rounded to powers of two so
    streaming ticks reuse a handful of buffers and never reallocate.
    Staging rows beyond each worker's count are left as-is — their
    destination is -1 and the kernel drops them, so stale payload words can
    never surface. The driver reads each worker's arrivals back into a host
    buffer kept for that worker (pinned on the card), grown to a power of two
    and reused.
    """

    def __init__(self, n: int, device: torch.device):
        self.n = n
        self.device = device
        self._staging: dict[tuple, _Staging] = {}
        pin = device.type == "cuda"
        self._counts_host = torch.empty((n, n), dtype=torch.int32, pin_memory=pin)
        self._readback: list[torch.Tensor | None] = [None] * n  # each worker's arrivals
        # observability counters (read via Comm.comm_stats)
        self.collectives = 0
        self.rows_moved = 0
        #: host ns of the driver's steps, summed over its ticks: pack, the upload's enqueue, the
        #: kernel's enqueue with the wait for it (upload and the counts' copy included), and the
        #: readback of the arrived rows with its wait
        self.step_ns = {"pack": 0, "upload": 0, "kernel": 0, "readback": 0}
        # cached like every other instrumented site — the per-tick hot
        # path must not pay module lookups when tracing is off
        from ..internals.tracing import get_tracer

        self._tracer = get_tracer()

    def note_collective(self, rows: int) -> None:
        self.collectives += 1
        self.rows_moved += int(rows)

    def stats(self) -> dict[str, float]:
        return {
            "mesh_collectives": float(self.collectives),
            "mesh_rows_moved": float(self.rows_moved),
            **{f"mesh_{k}_ms": v / 1e6 for k, v in self.step_ns.items()},
        }

    def width(self, kinds: list[str]) -> int:
        return 2 * (2 + sum(1 for k in kinds if k != HOST))

    # -- the fused driver step (worker 0 only) ---------------------------

    def run_tick(
        self,
        payloads: list[tuple],  # per worker: (sig, counts, local, dest)
        column_names: list[str],
    ) -> tuple | None:
        """Pack every worker's rows into one staging buffer, upload it with
        one non-blocking copy, run the bucketing kernel and read back the rows
        that arrived. Returns (kinds, cap_bucket, rows, arrived): ``rows[d]``
        the rows that arrived at worker ``d``, source-major, uint32 ``[sum of
        arrived[d], width]`` on the host (valid until the next tick), and
        ``arrived`` ``[n_dst, n_src]`` the rows from each source; complete when
        this returns (the peers read it after the caller's next barrier), or
        None when the tick moves no rows."""
        import time as _time

        from ..parallel import exchange

        counts_all = [p[1] for p in payloads]
        total_rows = sum(int(c.sum()) for c in counts_all)
        if total_rows == 0:
            return None
        self.note_collective(total_rows)
        tracer = self._tracer
        t0 = _time.perf_counter_ns()
        kinds = agree_kinds([p[0] for p in payloads], len(column_names))
        cap_in = _pow2(max(int(c.sum()) for c in counts_all))
        cap_bucket = _pow2(max(int(c.max()) for c in counts_all))
        width = self.width(kinds)

        stage = self.pack_blocks(
            [(local, dest) for _, _, local, dest in payloads],
            kinds, column_names, cap_in,
        )
        t1 = _time.perf_counter_ns()
        if self.device.type == "cuda":
            stage.dev.copy_(stage.host, non_blocking=True)
            stage.uploaded = torch.cuda.Event()
            stage.uploaded.record()
        t2 = _time.perf_counter_ns()
        rows = self.n * cap_in
        out_vals, _, counts = exchange.bucket_exchange(
            stage.dev[: rows * width].view(self.n, cap_in, width),
            stage.dev[rows * width:].view(self.n, cap_in), self.n, cap_bucket,
            return_counts=True,
        )
        if self.device.type == "cuda":
            # the counts come back inside the wait for the kernel
            self._counts_host.copy_(counts, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            counts = self._counts_host
        arrived = counts.numpy().astype(np.int64)
        # every row sent must have arrived: cap_bucket holds the largest (source, destination)
        # count, so a difference is a fault of the bucketing, not an overflow
        if not np.array_equal(arrived, np.stack(counts_all, axis=1)):
            raise RuntimeError("mesh exchange: the buckets' counts differ from the rows sent")
        t3 = _time.perf_counter_ns()
        rows = self._read_back(out_vals, arrived, cap_bucket)
        t4 = _time.perf_counter_ns()
        for step, ns in (("pack", t1 - t0), ("upload", t2 - t1), ("kernel", t3 - t2),
                         ("readback", t4 - t3)):
            self.step_ns[step] += ns
        if tracer is not None:
            # the driver-side pack+ship+collective — the one span that
            # shows where a device tick's time actually went
            tracer.complete(
                "mesh.collective",
                t0,
                {"rows": total_rows, "cap_in": cap_in,
                 "cap_bucket": cap_bucket},
            )
        return (kinds, cap_bucket, rows, arrived)

    def pack_blocks(
        self,
        blocks: list[tuple[Delta | None, np.ndarray | None]],
        kinds: list[str],
        column_names: list[str],
        cap_in: int,
    ) -> _Staging:
        """Pack per-block (local Delta, dest) pairs into one pinned staging
        buffer of ``len(blocks) * cap_in`` rows — the single definition of
        the packed-word layout."""
        width = self.width(kinds)
        stage = self._stage(len(blocks), cap_in, width)
        vals, dst = stage.vals, stage.dst
        dst.fill(-1)
        for b, (local, dest) in enumerate(blocks):
            if local is None or not len(local):
                continue
            n_b = len(local)
            base = b * cap_in
            parts = [
                _pack_words(local.keys, "u"),
                _pack_words(local.diffs, "i"),
            ]
            for c, k in zip(column_names, kinds):
                if k != HOST:
                    parts.append(_pack_words(local.data[c], k))
            vals[base : base + n_b] = np.hstack(parts)
            dst[base : base + n_b] = dest
        return stage

    def _stage(self, n_blocks: int, cap_in: int, width: int) -> _Staging:
        key = (n_blocks, cap_in, width)
        stage = self._staging.get(key)
        if stage is None:
            stage = self._staging[key] = _Staging(n_blocks * cap_in, width, self.device)
        elif stage.uploaded is not None:
            # the pack below overwrites the pinned buffer: the previous
            # tick's non-blocking upload from it must have finished
            stage.uploaded.synchronize()
        return stage

    # -- the readback and each worker's unpacking ------------------------

    def _read_back(self, out_vals: torch.Tensor, arrived: np.ndarray,
                   cap_bucket: int) -> list[np.ndarray]:
        """Each destination's arrived rows, source-major, copied from its block of ``out_vals``
        into that worker's host buffer (pinned on the card, grown to a power of two and reused):
        the first ``arrived[d, s]`` slots of each source's bucket, one copy per run of adjacent
        buckets (a full bucket ends where the next begins), then one wait for them all. A worker
        with no arrivals gets an empty array and nothing is copied for it."""
        width = out_vals.shape[-1]
        rows = []
        for d in range(self.n):
            per_src = arrived[d]
            total = int(per_src.sum())
            if total == 0:
                rows.append(np.empty((0, width), dtype=np.uint32))
                continue
            buf = self._readback[d]
            if buf is None or buf.numel() < total * width:
                buf = self._readback[d] = torch.empty(
                    _pow2(total * width), dtype=torch.int32,
                    pin_memory=self.device.type == "cuda")
            block, at = out_vals[d], 0
            for start, length in _runs(per_src, cap_bucket):
                buf[at * width:(at + length) * width].view(length, width).copy_(
                    block[start:start + length], non_blocking=True)
                at += length
            rows.append(buf[: total * width].numpy().view(np.uint32).reshape(total, width))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return rows

    def unpack_arrivals(
        self,
        rows: np.ndarray,  # [sum of arrived, width] this worker's arrivals, source-major
        arrived: np.ndarray,  # [n_src] rows from each source
        kinds: list[str],
        column_names: list[str],
        host_cols: dict[int, dict[str, np.ndarray]],  # src -> {col: values}
    ) -> list[Delta]:
        """Per-source arrival blocks → Deltas, re-zipping host-path columns
        (same source order on both paths)."""
        out: list[Delta] = []
        at = 0
        for src in range(self.n):
            n_rows = int(arrived[src])
            hcols = host_cols.get(src, {})
            if n_rows == 0 and not hcols:
                continue
            blk = rows[at:at + n_rows]
            at += n_rows
            keys = _unpack_words(blk[:, 0:2], "u")
            diffs = _unpack_words(blk[:, 2:4], "i")
            data: dict[str, np.ndarray] = {}
            w = 4
            for c, k in zip(column_names, kinds):
                if k != HOST:
                    data[c] = _unpack_words(blk[:, w : w + 2], k)
                    w += 2
                else:
                    hv = hcols.get(c)
                    if hv is None or len(hv) != n_rows:
                        raise RuntimeError(
                            f"mesh exchange host/dense row mismatch from "
                            f"worker {src}: column {c!r} has "
                            f"{0 if hv is None else len(hv)} host rows vs "
                            f"{n_rows} dense arrivals"
                        )
                    data[c] = hv
            out.append(Delta(keys=keys, data=data, diffs=diffs))
        return out


def _runs(per_src: np.ndarray, cap_bucket: int) -> list[list[int]]:
    """[first slot, rows] of each source's arrivals in a destination block, in source order;
    a run that ends where the next source's bucket starts (a full bucket) takes it in."""
    runs: list[list[int]] = []
    for src, count in enumerate(per_src.tolist()):
        if not count:
            continue
        start = src * cap_bucket
        if runs and runs[-1][0] + runs[-1][1] == start:
            runs[-1][1] += count
        else:
            runs.append([start, count])
    return runs
