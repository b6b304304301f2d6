"""Mutable index engines: brute-force KNN on the card, LSH KNN, BM25 and hybrid fusion on the
host. Port of ``pathway_tpu/ops/index_engines.py``.

They implement the ``IndexEngine`` protocol that the dataflow engine's external-index node calls
(``add`` / ``remove`` / ``search``, plus ``add_batch``). ``BruteForceKnnEngine`` keeps its index on
the host in a capacity-doubling arena; a mirror on the device is synced on the first search after
a change, and scoring with top-k is the fused kernel of ``ops/knn.py``. ``LshKnnEngine``,
``BM25Engine`` and ``HybridEngine`` are the reference's host numpy and Python code, copied as it
is, so that ties and the order of candidates stay the reference's.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Callable

import numpy as np
import torch

from .._device import resolve_device
from ..utils.filters import compile_metadata_filter
from .knn import topk_scores

__all__ = ["BruteForceKnnEngine", "LshKnnEngine", "BM25Engine", "HybridEngine", "tokenize"]


def _as_json(filter_data: Any) -> Any:
    """Metadata as a JSON value: None stays None, a string is parsed (None when it is not JSON),
    a ``Json`` wrapper gives its value, anything else (a dict) is kept as it is."""
    if filter_data is None:
        return None
    if isinstance(filter_data, str):
        try:
            return json.loads(filter_data)
        except ValueError:
            return None
    from ..internals.json import Json

    if isinstance(filter_data, Json):
        return filter_data.value
    return filter_data


class _SlotArena:
    """Keyed slot allocator with a free list (host-side directory of the device-resident index
    block)."""

    def __init__(self) -> None:
        self.key_to_slot: dict[int, int] = {}
        self.slot_to_key: dict[int, int] = {}
        self.meta: dict[int, Any] = {}
        self.free: list[int] = []
        self.high = 0

    def alloc(self, key: int) -> int:
        slot = self.free.pop() if self.free else self.high
        if slot == self.high:
            self.high += 1
        self.key_to_slot[key] = slot
        self.slot_to_key[slot] = key
        return slot

    def release(self, key: int) -> int | None:
        slot = self.key_to_slot.pop(key, None)
        if slot is None:
            return None
        self.slot_to_key.pop(slot, None)
        self.meta.pop(slot, None)
        self.free.append(slot)
        return slot


class BruteForceKnnEngine:
    """Exact KNN on the card: the index block is one ``[capacity, dim]`` f32 tensor.

    ``metric``: "cos" (vectors L2-normalised at insert and query time), "ip" (raw inner product)
    or "l2" (negative squared distance). Capacity doubles on overflow."""

    def __init__(self, dimensions: int, *, metric: str = "cos",
                 reserved_space: int = 1024,
                 embedder: Callable[[str], np.ndarray] | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.dim = dimensions
        self.metric = metric
        self.embedder = embedder
        self.capacity = max(16, int(reserved_space))
        self._host = np.zeros((self.capacity, self.dim), dtype=np.float32)
        self._valid = np.zeros(self.capacity, dtype=bool)
        self._slots = _SlotArena()
        self._mirror: torch.Tensor | None = None  # device copy of _host, synced lazily
        self._mirror_valid: torch.Tensor | None = None
        self._dirty = True

    # operator snapshots pickle the whole engine; the device mirror is a cache rebuilt on the
    # first search after restore
    def __getstate__(self):
        st = dict(self.__dict__)
        st["_mirror"] = None
        st["_mirror_valid"] = None
        st["_dirty"] = True
        # the embedder may be an arbitrary closure (not picklable); the restoring node grafts
        # the freshly-constructed engine's embedder back
        st["embedder"] = None
        return st

    # -- mutation ----------------------------------------------------------
    def _vec(self, data: Any) -> np.ndarray:
        if isinstance(data, str):
            if self.embedder is None:
                raise TypeError("string data requires an embedder")
            batch = getattr(self.embedder, "embed_texts", None)
            # a models.Embedder works directly as the engine embedder
            data = batch([data])[0] if batch is not None else self.embedder(data)
        v = np.asarray(data, dtype=np.float32).reshape(-1)
        if v.shape[0] != self.dim:
            raise ValueError(f"vector dim {v.shape[0]} != index dim {self.dim}")
        if self.metric == "cos":
            # "ip" deliberately skips this: raw inner product keeps magnitude
            n = float(np.linalg.norm(v))
            if n > 0:
                v = v / n
        return v

    def add(self, key: int, data: Any, filter_data: Any) -> None:
        v = self._vec(data)
        if key in self._slots.key_to_slot:
            self._slots.release(key)
        slot = self._slots.alloc(key)
        if slot >= self.capacity:
            self._grow()
        self._host[slot] = v
        self._valid[slot] = True
        self._slots.meta[slot] = _as_json(filter_data)
        self._dirty = True

    def add_batch(self, keys: list[int], datas: list[Any], filters: list[Any]) -> None:
        """Bulk insertion: all string payloads of one tick are embedded in one batched forward.
        When every payload is then a vector and this is a plain brute-force engine (no subclass
        hooks), insertion is one vectorised slab write."""
        batch = getattr(self.embedder, "embed_texts", None)
        text_ix = [
            i for i, d in enumerate(datas) if isinstance(d, str)
        ] if batch is not None else []
        if text_ix:
            vecs = batch([datas[i] for i in text_ix])
            datas = list(datas)
            for j, i in enumerate(text_ix):
                datas[i] = np.asarray(vecs[j], dtype=np.float32)
        if type(self).add is BruteForceKnnEngine.add and not any(
            isinstance(d, str) for d in datas
        ):
            self._bulk_add(keys, datas, filters)
            return
        for k, d, f in zip(keys, datas, filters):
            self.add(k, d, f)

    def _bulk_add(self, keys: list[int], datas: list[Any], filters: list[Any]) -> None:
        n = len(keys)
        if n == 0:
            return
        try:
            vecs = np.stack([np.asarray(d, dtype=np.float32).reshape(-1) for d in datas])
        except ValueError:  # ragged dims — the per-row path raises the right error
            for k, d, f in zip(keys, datas, filters):
                self.add(k, d, f)
            return
        if vecs.shape[1] != self.dim:
            raise ValueError(f"vector dim {vecs.shape[1]} != index dim {self.dim}")
        if self.metric == "cos":
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            np.divide(vecs, norms, out=vecs, where=norms > 0)
        ikeys = [int(k) for k in keys]
        if len(set(ikeys)) != len(ikeys):
            # duplicate keys in one tick: keep only the last occurrence, as the per-row path
            # does, where each add replaces the previous slot
            last = {k: i for i, k in enumerate(ikeys)}
            keep = sorted(last.values())
            ikeys = [ikeys[i] for i in keep]
            vecs = vecs[keep]
            filters = [filters[i] for i in keep]
            n = len(ikeys)
        for k in ikeys:
            if k in self._slots.key_to_slot:
                self._slots.release(k)
        if self._slots.free:
            slots = np.array([self._slots.alloc(k) for k in ikeys], dtype=np.int64)
        else:  # fresh block: bulk dict updates, no per-key alloc calls
            start = self._slots.high
            slots = np.arange(start, start + n, dtype=np.int64)
            self._slots.high = start + n
            slot_list = slots.tolist()
            self._slots.key_to_slot.update(zip(ikeys, slot_list))
            self._slots.slot_to_key.update(zip(slot_list, ikeys))
        if self._slots.high > self.capacity:
            self._grow(self._slots.high)
        self._host[slots] = vecs
        self._valid[slots] = True
        for slot, f in zip(slots.tolist(), filters):
            if f is not None:
                self._slots.meta[slot] = _as_json(f)
        self._dirty = True

    def remove(self, key: int) -> None:
        slot = self._slots.release(key)
        if slot is not None:
            self._valid[slot] = False
            self._dirty = True

    def _grow(self, needed: int | None = None) -> None:
        new_cap = self.capacity * 2
        while new_cap < (needed or 0):
            new_cap *= 2
        host = np.zeros((new_cap, self.dim), dtype=np.float32)
        host[: self.capacity] = self._host
        valid = np.zeros(new_cap, dtype=bool)
        valid[: self.capacity] = self._valid
        self._host, self._valid, self.capacity = host, valid, new_cap

    def _sync(self) -> None:
        """Copy the host arena to the device mirror, in place while the capacity is unchanged."""
        if self._mirror is None or self._mirror.shape[0] != self.capacity:
            self._mirror = torch.empty((self.capacity, self.dim), dtype=torch.float32,
                                       device=self.device)
            self._mirror_valid = torch.empty((self.capacity,), dtype=torch.bool,
                                             device=self.device)
        self._mirror.copy_(torch.from_numpy(self._host))
        self._mirror_valid.copy_(torch.from_numpy(self._valid))
        self._dirty = False

    # -- search ------------------------------------------------------------
    def search(self, queries: list[Any], limits: list[int], filters: list[Any]):
        n = self._slots.high
        if n == 0 or not queries:
            return [[] for _ in queries]
        dev_embed = getattr(self.embedder, "embed_texts_device", None)
        if dev_embed is not None and all(isinstance(x, str) for x in queries):
            # query embeddings (already L2-normalised by the model head) stay on the device
            # into the scorer: embed -> score -> top-k, with one fetch at _pack time
            q = dev_embed(list(queries))
        else:
            q = torch.from_numpy(np.stack([self._vec(x) for x in queries]))
        q = q.to(self.device, torch.float32)
        if self._dirty or self._mirror is None:
            self._sync()

        kmax = min(max(limits), int(self._valid.sum()))
        if kmax <= 0:
            return [[] for _ in queries]

        filt_fns = [compile_metadata_filter(f) for f in filters]
        if any(f is not None for f in filt_fns):
            # per-query validity: the metadata filter runs on the host directory and applies
            # as a -inf mask before the top-k on the device
            out = []
            for qi, (fv, lim) in enumerate(zip(filt_fns, limits)):
                mask = self._valid.copy()
                if fv is not None:
                    for slot in range(n):
                        if mask[slot] and not fv(self._slots.meta.get(slot)):
                            mask[slot] = False
                k_eff = min(lim, int(mask.sum()))
                if k_eff <= 0:
                    out.append([])
                    continue
                s, ids = topk_scores(
                    q[qi : qi + 1], self._mirror, k_eff, self.metric,
                    valid=torch.from_numpy(mask).to(self.device),
                )
                out.append(self._pack(s[0].cpu().numpy(), ids[0].cpu().numpy(), lim))
            return out

        s, ids = topk_scores(q, self._mirror, kmax, self.metric, valid=self._mirror_valid)
        s, ids = s.cpu().numpy(), ids.cpu().numpy()
        return [self._pack(s[i], ids[i], limits[i]) for i in range(len(queries))]

    def _pack(self, scores: np.ndarray, slots: np.ndarray, limit: int):
        out = []
        for sc, slot in zip(scores, slots):
            if len(out) >= limit or not np.isfinite(sc):
                break
            key = self._slots.slot_to_key.get(int(slot))
            if key is not None:
                out.append((key, float(sc)))
        return out


class LshKnnEngine(BruteForceKnnEngine):
    """LSH-bucketed approximate KNN (reference ``LshKnn``, ``stdlib/ml/index.py`` classic impl):
    random-hyperplane signatures route vectors to buckets, and a query scores only its buckets'
    candidates. All of it is host numpy: the candidates score with ``block @ v`` on the host, not
    through the card's kernel (the reference's docstring says otherwise; its ``search`` is numpy
    too). ``device`` is only where the base class would keep its mirror, which this engine never
    searches."""

    def __init__(self, dimensions: int, *, metric: str = "cos",
                 reserved_space: int = 1024, n_or: int = 4, n_and: int = 8,
                 bucket_length: float | None = None, seed: int = 0,
                 embedder: Callable[[str], np.ndarray] | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(dimensions, metric=metric, reserved_space=reserved_space,
                         embedder=embedder, device=device)
        rng = np.random.default_rng(seed)
        self.n_or = n_or
        self.n_and = n_and
        self._planes = rng.standard_normal((n_or, n_and, dimensions)).astype(np.float32)
        self._buckets: list[dict[int, set[int]]] = [dict() for _ in range(n_or)]
        self._slot_sigs: dict[int, list[int]] = {}

    def _signatures(self, v: np.ndarray) -> list[int]:
        bits = (np.einsum("oad,d->oa", self._planes, v) > 0).astype(np.uint64)
        weights = (2 ** np.arange(self.n_and, dtype=np.uint64))
        return [int((bits[o] * weights).sum()) for o in range(self.n_or)]

    def add(self, key: int, data: Any, filter_data: Any) -> None:
        if key in self._slots.key_to_slot:
            # clean old bucket entries before re-slotting (plain super().add would re-allocate
            # the slot and leak the old signatures)
            self.remove(key)
        super().add(key, data, filter_data)
        slot = self._slots.key_to_slot[key]
        sigs = self._signatures(self._host[slot])
        self._slot_sigs[slot] = sigs
        for o, sig in enumerate(sigs):
            self._buckets[o].setdefault(sig, set()).add(slot)

    def remove(self, key: int) -> None:
        slot = self._slots.key_to_slot.get(key)
        super().remove(key)
        if slot is not None:
            for o, sig in enumerate(self._slot_sigs.pop(slot, [])):
                self._buckets[o].get(sig, set()).discard(slot)

    def search(self, queries: list[Any], limits: list[int], filters: list[Any]):
        if self._slots.high == 0 or not queries:
            return [[] for _ in queries]
        filt_fns = [compile_metadata_filter(f) for f in filters]
        out = []
        for qd, lim, fv in zip(queries, limits, filt_fns):
            v = self._vec(qd)
            cand: set[int] = set()
            for o, sig in enumerate(self._signatures(v)):
                cand |= self._buckets[o].get(sig, set())
            cand = {s for s in cand if self._valid[s]}
            if fv is not None:
                cand = {s for s in cand if fv(self._slots.meta.get(s))}
            if not cand:
                out.append([])
                continue
            slots = np.fromiter(cand, dtype=np.int64)
            block = self._host[slots]
            if self.metric in ("cos", "ip"):
                scores = block @ v
            else:
                scores = -((block - v[None, :]) ** 2).sum(axis=1)
            top = np.argsort(-scores)[:lim]
            out.append([
                (self._slots.slot_to_key[int(slots[i])], float(scores[i]))
                for i in top
            ])
        return out


_TOKEN_RE = re.compile(r"[A-Za-z0-9_]+")


def tokenize(text: str) -> list[str]:
    return [t.lower() for t in _TOKEN_RE.findall(text)]


class BM25Engine:
    """In-memory BM25 full-text index on the host (replaces the reference's Tantivy integration,
    ``tantivy_integration.rs``): an inverted index token -> {key: tf}, Okapi BM25 scoring with
    k1/b."""

    def __init__(self, *, ram_budget: int = 0, in_memory_index: bool = True,
                 k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self._postings: dict[str, dict[int, int]] = {}
        self._doc_len: dict[int, int] = {}
        self._doc_tokens: dict[int, list[str]] = {}
        self._meta: dict[int, Any] = {}

    def add(self, key: int, data: Any, filter_data: Any) -> None:
        if key in self._doc_len:
            self.remove(key)
        toks = tokenize(str(data))
        self._doc_tokens[key] = toks
        self._doc_len[key] = len(toks)
        self._meta[key] = _as_json(filter_data)
        for t in toks:
            self._postings.setdefault(t, {})
            self._postings[t][key] = self._postings[t].get(key, 0) + 1

    def remove(self, key: int) -> None:
        toks = self._doc_tokens.pop(key, None)
        if toks is None:
            return
        self._doc_len.pop(key, None)
        self._meta.pop(key, None)
        for t in set(toks):
            plist = self._postings.get(t)
            if plist is not None:
                plist.pop(key, None)
                if not plist:
                    del self._postings[t]

    def search(self, queries: list[Any], limits: list[int], filters: list[Any]):
        n_docs = len(self._doc_len)
        if n_docs == 0 or not queries:
            return [[] for _ in queries]
        avgdl = sum(self._doc_len.values()) / n_docs
        filt_fns = [compile_metadata_filter(f) for f in filters]
        out = []
        for q, lim, fv in zip(queries, limits, filt_fns):
            scores: dict[int, float] = {}
            for t in tokenize(str(q)):
                plist = self._postings.get(t)
                if not plist:
                    continue
                idf = math.log(1.0 + (n_docs - len(plist) + 0.5) / (len(plist) + 0.5))
                for key, tf in plist.items():
                    dl = self._doc_len[key]
                    denom = tf + self.k1 * (1 - self.b + self.b * dl / avgdl)
                    scores[key] = scores.get(key, 0.0) + idf * tf * (self.k1 + 1) / denom
            ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
            if fv is not None:
                ranked = [(k, s) for k, s in ranked if fv(self._meta.get(k))]
            out.append([(k, float(s)) for k, s in ranked[:lim] if s > 0])
        return out


class HybridEngine:
    """Reciprocal-rank fusion over sub-engines (reference ``HybridIndex``,
    ``stdlib/indexing/hybrid_index.py``): score = sum of 1 / (rrf_k + rank). The fusion is host
    Python; a brute-force sub-engine still searches on the card."""

    def __init__(self, engines: list[Any], *, rrf_k: int = 60,
                 adapters: list[Callable[[Any], Any]] | None = None):
        self.engines = engines
        self.rrf_k = rrf_k
        self.adapters = adapters or [None] * len(engines)

    def add(self, key: int, data: Any, filter_data: Any) -> None:
        for eng, ad in zip(self.engines, self.adapters):
            eng.add(key, ad(data) if ad else data, filter_data)

    def remove(self, key: int) -> None:
        for eng in self.engines:
            eng.remove(key)

    def search(self, queries: list[Any], limits: list[int], filters: list[Any]):
        # each sub-engine retrieves a deeper pool so fusion has candidates
        deep = [max(l * 2, l + 5) for l in limits]
        per_engine = [
            eng.search([ad(q) if ad else q for q in queries], deep, filters)
            for eng, ad in zip(self.engines, self.adapters)
        ]
        out = []
        for qi in range(len(queries)):
            fused: dict[int, float] = {}
            for replies in per_engine:
                for rank, (key, _score) in enumerate(replies[qi]):
                    fused[key] = fused.get(key, 0.0) + 1.0 / (self.rrf_k + rank + 1)
            ranked = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))
            out.append([(k, float(s)) for k, s in ranked[: limits[qi]]])
        return out
