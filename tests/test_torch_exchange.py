"""The port's bucketed all-to-all against the JAX package's, on the CPU.

``pathway_tpu_torch.parallel.exchange.bucketed_all_to_all`` (the plain version of the
``bucket_exchange`` kernel on CPU tensors) against ``pathway_tpu.parallel.exchange`` on meshes
of 2, 4 and 8 CPU devices: rows with no destination (-1), buckets forced to overflow (rows past
``cap_bucket`` dropped, as JAX drops them) and words that carry negative int64 values and NaN
floats. The rank form runs over gloo in 2 and 4 processes (``torch_dist_child.py``) against
each JAX device block. The mesh exchange's word packing round-trips 64-bit keys, negative diffs,
NaN floats and booleans, and re-zips host columns in source order.

Tolerance: none. The exchange moves bits; values and validity are compared bitwise.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pathway_tpu.engine import mesh_exchange as jmx
from pathway_tpu.parallel.exchange import bucketed_all_to_all as jax_all_to_all
from pathway_tpu.parallel.exchange import shard_rows as jax_shard_rows
from pathway_tpu_torch.engine import mesh_exchange as tmx
from pathway_tpu_torch.engine.delta import Delta
from pathway_tpu_torch.parallel.exchange import (
    bucket_exchange,
    bucket_exchange_plain,
    bucketed_all_to_all,
    shard_rows,
)
from torch_dist_child import RankRun


def _words(rng, rows: int, w: int) -> np.ndarray:
    """uint32 words whose pairs are negative int64s, NaN floats with payload bits and keys with
    the high bit set."""
    out = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64).astype(np.uint32)
    pairs = out.reshape(rows, w // 2, 2)
    neg = (-rng.integers(1, 2**62, size=rows)).astype(np.int64)
    pairs[:, 0] = neg.view(np.uint32).reshape(rows, 2)
    nan = np.full(rows, np.nan)
    nan_bits = nan.view(np.uint64) | rng.integers(1, 2**20, size=rows).astype(np.uint64)
    pairs[:, -1] = nan_bits.view(np.uint32).reshape(rows, 2)
    return out


def _case(n: int, cap_in: int, w: int, cap_bucket: int, seed: int, fill: float = 0.8):
    """Global values ``[n * cap_in, w]`` and dest ``[n * cap_in]``: each source block holds
    ``fill * cap_in`` rows, the rest -1, and some -1 rows among them."""
    rng = np.random.default_rng(seed)
    values = _words(rng, n * cap_in, w)
    dest = rng.integers(0, n, size=n * cap_in).astype(np.int32)
    used = int(fill * cap_in)
    for s in range(n):
        dest[s * cap_in + used:(s + 1) * cap_in] = -1
    dest[rng.random(n * cap_in) < 0.1] = -1
    return values, dest, n * cap_bucket


CASES = {
    # (n, cap_in, w, cap_bucket): buckets that hold everything, and ones forced to overflow
    "n2": (2, 16, 4, 16),
    "n2_overflow": (2, 32, 6, 4),
    "n4": (4, 64, 8, 64),
    "n4_overflow": (4, 64, 4, 8),
    "n8": (8, 32, 10, 32),
    "n8_overflow": (8, 128, 16, 8),
}


@functools.cache
def _jax(name: str):
    n, cap_in, w, cap_bucket = CASES[name]
    values, dest, cap_out = _case(n, cap_in, w, cap_bucket, seed=len(name) * 7 + n)
    mesh = Mesh(np.array(jax.devices()[:n]), ("workers",))
    kernel = jax.jit(lambda v, d: jax_all_to_all(mesh, "workers", v, d, cap_out))
    out, valid = kernel(values, dest)
    return values, dest, cap_out, np.asarray(out), np.asarray(valid)


@pytest.mark.parametrize("name", list(CASES))
def test_all_to_all_equals_jax_bitwise(name):
    n, cap_in, w, cap_bucket = CASES[name]
    values, dest, cap_out, j_out, j_valid = _jax(name)
    out, valid = bucketed_all_to_all(values, dest, n, cap_out, device="cpu")
    assert bucket_exchange.launches == 0  # CPU tensors run the plain version
    assert out.shape == (n, cap_out, w) and valid.shape == (n, cap_out)
    np.testing.assert_array_equal(out.numpy().view(np.uint32).reshape(-1, w), j_out)
    np.testing.assert_array_equal(valid.numpy().reshape(-1), j_valid)
    if "overflow" in name:  # the case drops rows, and keeps the first cap_bucket of each bucket
        kept = int(valid.sum())
        assert kept < int((dest >= 0).sum())
        assert kept == sum(
            min(cap_bucket, int((dest[s * cap_in:(s + 1) * cap_in] == d).sum()))
            for s in range(n) for d in range(n)
        )


def test_slots_keep_source_row_order():
    # one source, one destination: the arrivals are the source rows in order, dest -1 skipped
    values = torch.arange(24, dtype=torch.int32).reshape(1, 12, 2)
    dest = torch.tensor([[0, -1, 0, 0, -1, 0, 0, 0, -1, 0, 0, 0]], dtype=torch.int32)
    out, valid = bucket_exchange_plain(values, dest, 1, 16)
    rows = [r for r in range(12) if dest[0, r] == 0]
    np.testing.assert_array_equal(out[0, : len(rows)].numpy(), values[0, rows].numpy())
    assert valid[0].sum() == len(rows) and not out[0, len(rows):].any()


def test_all_to_all_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    values, dest, cap_out = _case(2, 8, 4, 8, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bucketed_all_to_all(values, dest, 2, cap_out)


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """The rank form in 2 and 4 gloo processes; each rank exchanges its block of every case of
    that size."""
    runs = {}
    for world in (2, 4):
        cases = {k: _jax(k)[:3] for k, c in CASES.items() if c[0] == world}
        runs[world] = (cases, RankRun("exchange", world,
                                      tmp_path_factory.mktemp(f"x{world}"), {"cases": cases}))
    return {w: (cases, run.results()) for w, (cases, run) in runs.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_rank_form_equals_each_jax_device_block(rank_runs, world):
    cases, results = rank_runs[world]
    for name in cases:
        _, _, cap_out, j_out, j_valid = _jax(name)
        w = j_out.shape[1]
        for rank, r in enumerate(results):
            block = slice(rank * cap_out, (rank + 1) * cap_out)
            np.testing.assert_array_equal(r[f"{name}_out"].view(np.uint32).reshape(-1, w),
                                          j_out[block])
            np.testing.assert_array_equal(r[f"{name}_valid"], j_valid[block])
    for r in results:
        assert r["loaded_reference_modules"].size == 0, r["loaded_reference_modules"]


def _delta(rng, n: int, with_host: bool) -> Delta:
    data = {
        "i": (-rng.integers(0, 2**62, n)).astype(np.int64),
        "u": rng.integers(0, 2**64, n, dtype=np.uint64),
        "f": np.where(rng.random(n) < 0.3, np.nan, rng.standard_normal(n)),
        "b": rng.random(n) < 0.5,
    }
    if with_host:
        data["s"] = np.array([f"s{x}" for x in rng.integers(0, 50, n)], dtype=object)
    keys = rng.integers(2**63, 2**64, n, dtype=np.uint64)
    return Delta(keys=keys, data=data, diffs=rng.integers(-3, 4, n))


def _payloads(rng, n: int, cols: list[str], with_host: bool, skip: int | None = None):
    """n workers' deltas with random destinations (none to worker ``skip``), as deposited."""
    payloads = []
    for w in range(n):
        d = _delta(rng, 20 + 7 * w, with_host)
        dest = rng.integers(0, n, len(d)).astype(np.int32)
        if skip is not None:
            dest[dest == skip] = (skip + 1) % n
        counts = np.bincount(dest, minlength=n).astype(np.int64)
        payloads.append((tmx.local_signature(d, cols), counts, d, dest))
    return payloads


def _host_cols(payloads, me: int, with_host: bool) -> dict:
    host_cols = {}
    if with_host:
        for src, (_, _, d, dest) in enumerate(payloads):
            ix = np.flatnonzero(dest == me)
            if len(ix):
                host_cols[src] = {"s": d.data["s"][ix]}
    return host_cols


def _assert_arrivals(got, payloads, me: int, cols: list[str]) -> None:
    want = [p[2].take(np.flatnonzero(p[3] == me)) for p in payloads]
    want = [d for d in want if len(d)]
    assert len(got) == len(want)
    for g, wd in zip(got, want):
        np.testing.assert_array_equal(g.keys, wd.keys)
        np.testing.assert_array_equal(g.diffs, wd.diffs)
        for c in cols:
            if c == "f":
                np.testing.assert_array_equal(g.data[c].view(np.uint64),
                                              wd.data[c].view(np.uint64))
            else:
                np.testing.assert_array_equal(g.data[c], wd.data[c])


@pytest.mark.parametrize("with_host", [False, True])
def test_runner_round_trips_bits_and_host_columns(with_host):
    """Three workers' deltas through the port's runner (the driver's pack, the plain bucketing,
    the readback of each worker's arrived rows, each worker's unpack): every worker's arrivals
    equal the rows sent to it, in source order, with bits unchanged; the packed words equal the
    JAX runner's."""
    rng = np.random.default_rng(5 + with_host)
    cols = ["i", "u", "f", "b"] + (["s"] if with_host else [])
    n = 3
    runner = tmx.MeshExchangeRunner(n, torch.device("cpu"))
    payloads = _payloads(rng, n, cols, with_host)
    kinds, cap_bucket, rows, arrived = runner.run_tick(payloads, cols)
    assert kinds == jmx.agree_kinds([p[0] for p in payloads], len(cols))
    cap_in = tmx._pow2(max(len(p[2]) for p in payloads))
    stage = runner.pack_blocks([(p[2], p[3]) for p in payloads], kinds, cols, cap_in)
    mesh = Mesh(np.array(jax.devices()[:n]), ("workers",))
    jv, jd = jmx.MeshExchangeRunner(mesh, "workers").pack_blocks(
        [(p[2], p[3]) for p in payloads], kinds, cols, cap_in)
    np.testing.assert_array_equal(stage.vals, jv)
    np.testing.assert_array_equal(stage.dst, jd)
    for me in range(n):
        got = runner.unpack_arrivals(rows[me], arrived[me], kinds, cols,
                                     _host_cols(payloads, me, with_host))
        _assert_arrivals(got, payloads, me, cols)


@pytest.mark.parametrize("with_host", [False, True])
def test_runner_readback_skips_a_worker_with_no_arrivals(with_host):
    """Four workers, none sending to worker 2: nothing is read back for it and it unpacks to no
    delta; the others' arrivals (host-path columns re-zipped) equal the rows sent to them, read
    back tick after tick into the same reused buffers."""
    rng = np.random.default_rng(11 + with_host)
    cols = ["i", "u", "f", "b"] + (["s"] if with_host else [])
    n = 4
    runner = tmx.MeshExchangeRunner(n, torch.device("cpu"))
    buffers = set()
    for _ in range(3):
        payloads = _payloads(rng, n, cols, with_host, skip=2)
        kinds, _, rows, arrived = runner.run_tick(payloads, cols)
        assert not arrived[2].any()
        for me in range(n):
            assert rows[me].shape == (int(arrived[me].sum()), runner.width(kinds))
            got = runner.unpack_arrivals(rows[me], arrived[me], kinds, cols,
                                         _host_cols(payloads, me, with_host))
            if me == 2:
                assert got == [] and runner._readback[2] is None
            _assert_arrivals(got, payloads, me, cols)
        buffers.update(id(b) for b in runner._readback if b is not None)
    assert len(buffers) <= 2 * (n - 1)  # grown at most once a worker, then reused


@pytest.mark.parametrize("name", list(CASES))
def test_readback_counts_equal_the_jax_validity_mask(name):
    """The counts the readback uses (the bucketing's, one per destination and source) equal what
    the JAX function's validity mask holds in each bucket, and each bucket's valid slots are its
    first ones."""
    n, cap_in, w, cap_bucket = CASES[name]
    values, dest, cap_out, _, j_valid = _jax(name)
    v = torch.from_numpy(values.view(np.int32)).reshape(n, cap_in, w)
    _, _, counts = bucket_exchange(v, torch.from_numpy(dest).reshape(n, cap_in), n, cap_bucket,
                                   return_counts=True)
    buckets = j_valid.reshape(n, n, cap_bucket)
    np.testing.assert_array_equal(counts.numpy(), buckets.sum(-1))
    assert counts.dtype == torch.int32
    for d in range(n):
        for s in range(n):
            assert buckets[d, s, :counts[d, s]].all() and not buckets[d, s, counts[d, s]:].any()


def test_runs_merge_full_buckets():
    assert tmx._runs(np.array([4, 4, 0, 2, 4, 1]), 4) == [[0, 8], [12, 2], [16, 5]]
    assert tmx._runs(np.array([0, 4, 4, 1]), 4) == [[4, 9]]
    assert tmx._runs(np.array([0, 0, 0]), 4) == []


@pytest.mark.parametrize("n", [1, 3, 8])
def test_shard_rows_equals_jax(n):
    keys = np.random.default_rng(n).integers(0, 2**64, 500, dtype=np.uint64)
    np.testing.assert_array_equal(shard_rows(keys, n), jax_shard_rows(keys, n))
