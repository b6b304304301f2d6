"""The port's native keyspace module (``pathway_tpu_torch/native``) against the port's own
pure-Python paths and against the reference's keys, bit for bit.

Every comparison here is exact: keys are 64-bit integers, and the port's keys must be the
reference's keys. The cases follow ``tests/test_native.py`` (the reference's parity suite), on
seeded numpy inputs of every value class the engine hashes.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import pathway_tpu.engine.keys as RK
from pathway_tpu.native import get_native
from pathway_tpu_torch import native as port_native
from pathway_tpu_torch.engine import keys as K
from pathway_tpu_torch.engine.slotmap import SlotMap, SlotMapPlain

REPO = Path(__file__).resolve().parents[1]
N = port_native.load()

CORPUS_ROWS = [
    (),
    (None,),
    (True, False),
    (0, 1, -1, 2**62, -(2**62), 123456789),
    (0.0, -0.0, 1.5, float("inf"), -2.75e300),
    ("", "hello", "héllo wörld", "x" * 1000),
    (b"", b"raw\x00bytes", b"y" * 500),
    (("nested", 1), ("deep", ("er", 2.5), None)),
    (np.int64(42), np.float64(2.5), np.bool_(True)),
    (np.array([1.0, 2.0, 3.0]),),
    ({"a": 1},),  # hashed by its repr through the Python fallback
]


def seeded_columns(seed: int, n: int = 300) -> dict[str, np.ndarray]:
    """One column of each value class the engine hashes, from ``seed``."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-(2**62), 2**62, n)
    floats = rng.standard_normal(n) * 1e3
    words = np.array([f"w{i}-{'é' * (i % 3)}" for i in rng.integers(0, 50, n)], dtype=object)
    mixed = np.empty(n, dtype=object)
    for i in range(n):
        kind = i % 8
        mixed[i] = (
            None if kind == 0 else
            bool(ints[i] & 1) if kind == 1 else
            int(ints[i]) if kind == 2 else
            float(floats[i]) if kind == 3 else
            str(words[i]) if kind == 4 else
            str(words[i]).encode() if kind == 5 else
            (int(ints[i] % 7), str(words[i]), None) if kind == 6 else
            rng.standard_normal(3)
        )
    return {
        "int64": ints.astype(np.int64),
        "int32": (ints % 1000).astype(np.int32),
        "float64": floats,
        "bool": ints % 3 == 0,
        "uint64": ints.view(np.uint64),
        "str": words,
        "bytes": np.array([str(w).encode() for w in words], dtype=object),
        "mixed": mixed,
    }


@pytest.fixture
def fresh_registry(monkeypatch):
    """A registry of this test's own in both packages; the process-wide ones come back after."""
    monkeypatch.setattr(K, "_REGISTRY", None)
    monkeypatch.setattr(RK, "_REGISTRY", None)
    yield


# -- the module and its build ------------------------------------------------------------------


def test_module_name_differs_from_the_reference_and_both_load():
    ref = get_native()
    assert N.__name__ == "_pathway_torch_native"
    assert N.KeyTable.__module__ == "_pathway_torch_native"
    assert ref is not None and ref.__name__ == "_pathway_native"
    assert N is not ref and N.KeyRegistry is not ref.KeyRegistry
    assert Path(N.__file__).parent == REPO / "pathway_tpu_torch" / "_build"


def test_source_is_the_reference_with_the_module_renamed():
    ours = (REPO / "pathway_tpu_torch/native/native.c").read_text()
    ref = (REPO / "pathway_tpu/native/native.c").read_text()
    body = lambda s: s[s.index("#define PY_SSIZE_T_CLEAN"):]  # noqa: E731 — after the head comment
    assert body(ours).replace("_pathway_torch_native", "_pathway_native").replace(
        "kernels for pathway_tpu_torch", "kernels for pathway_tpu") == body(ref)
    assert "pathway_tpu/native/native.c" in ours[:ours.index("#define PY_SSIZE_T_CLEAN")]


@pytest.mark.parametrize("cc", ["/nonexistent/cc", "false"])
def test_a_failed_build_raises(tmp_path, cc):
    """A compiler that is missing or fails raises ``RuntimeError`` with its output; the build path
    points at an empty directory, so no library built before can answer."""
    code = textwrap.dedent(f"""
        from pathlib import Path
        from pathway_tpu_torch import native
        native._BUILD = Path({str(tmp_path)!r})
        try:
            native.load()
        except RuntimeError as e:
            print("RAISED", "did not build" in str(e), {cc!r} in str(e))
        else:
            print("LOADED")
    """)
    env = {**os.environ, "CC": cc, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=120)
    assert out.stdout.split() == ["RAISED", "True", "True"], out.stdout + out.stderr
    assert not any(tmp_path.glob("*.so"))


def test_build_reuses_the_library():
    assert port_native.build() is None  # built at import of this file; the same source reuses it


# -- hashing primitives -------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 11, 127, 128, 129, 1000])
def test_blake2b8_and_16hi_match_hashlib(n):
    data = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
    assert N.blake2b8(data) == int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                                              "little")
    assert N.blake2b16hi(data) == int.from_bytes(
        hashlib.blake2b(data, digest_size=16).digest()[8:16], "little")


def test_splitmix_lanes_match_python():
    for x in (0, 1, 0xDEADBEEF, 2**63, 2**64 - 1, 0x9E3779B97F4A7C15):
        assert N.splitmix64(x) == int(K._splitmix(np.uint64(x))) == K._splitmix_int(x)
        assert N.splitmix64_2(x) == K._splitmix2_int(x) == int(K._splitmix2(np.uint64(x)))


@pytest.mark.parametrize("salt", [0, 7, 0xC0])
def test_hash_rows_and_rows2_match_python(salt):
    out = np.empty(len(CORPUS_ROWS), dtype=np.uint64)
    N.hash_rows(CORPUS_ROWS, salt, K._hash_scalar, out)
    np.testing.assert_array_equal(out, K._hash_values_py(CORPUS_ROWS, salt))
    lo = np.empty(len(CORPUS_ROWS), dtype=np.uint64)
    hi = np.empty(len(CORPUS_ROWS), dtype=np.uint64)
    N.hash_rows2(CORPUS_ROWS, salt, salt, K._hash_scalar, K._hash_scalar_hi, None, lo, hi)
    np.testing.assert_array_equal(lo, out)  # the LO lane is the engine's keyspace
    want_hi = []
    for row in CORPUS_ROWS:
        acc = K._ROW_SEED_HI ^ salt
        for v in row:
            acc = K._splitmix2_int(acc ^ K._hash_scalar_hi(v))
        want_hi.append(acc)
    assert hi.tolist() == want_hi


def test_hash_scalars2_matches_python():
    flat = [v for row in CORPUS_ROWS for v in row]
    lo = np.empty(len(flat), dtype=np.uint64)
    hi = np.empty(len(flat), dtype=np.uint64)
    N.hash_scalars2(flat, K._hash_scalar, K._hash_scalar_hi, None, lo, hi)
    assert lo.tolist() == [K._hash_scalar(v) & K._M64 for v in flat]
    assert hi.tolist() == [K._hash_scalar_hi(v) for v in flat]


def test_string_memo_gives_the_same_bits():
    vals = ["alpha", "beta", "alpha", "beta", "alpha"] * 10
    memo: dict = {}
    lo_m, hi_m = np.empty(len(vals), np.uint64), np.empty(len(vals), np.uint64)
    N.hash_scalars2(vals, K._hash_scalar, K._hash_scalar_hi, memo, lo_m, hi_m)
    lo, hi = np.empty(len(vals), np.uint64), np.empty(len(vals), np.uint64)
    N.hash_scalars2(vals, K._hash_scalar, K._hash_scalar_hi, None, lo, hi)
    np.testing.assert_array_equal(lo_m, lo)
    np.testing.assert_array_equal(hi_m, hi)
    assert set(memo) == {"alpha", "beta"}
    out_m, lomemo = np.empty(len(vals), np.uint64), {}
    N.hash_scalars(vals, K._hash_scalar, out_m, lomemo)
    np.testing.assert_array_equal(out_m, lo)
    # a second pass reads the memo and agrees with the first
    N.hash_scalars2(vals, K._hash_scalar, K._hash_scalar_hi, memo, lo_m, hi_m)
    np.testing.assert_array_equal(lo_m, lo)


# -- keys.py's native paths against its plain versions and the reference -------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_object_columns_against_plain_and_reference(seed):
    for name, col in seeded_columns(seed).items():
        if col.dtype != object:
            continue
        lo = K._hash_object_column(col)
        np.testing.assert_array_equal(lo, K._hash_object_column_plain(col), err_msg=name)
        np.testing.assert_array_equal(lo, RK._hash_object_column(col), err_msg=name)
        lo2, hi2 = K._hash_object_column2(col)
        plo, phi = K._hash_object_column2_plain(col)
        rlo, rhi = RK._hash_object_column2(col)
        np.testing.assert_array_equal(lo2, lo, err_msg=name)
        np.testing.assert_array_equal(lo2, plo, err_msg=name)
        np.testing.assert_array_equal(hi2, phi, err_msg=name)
        np.testing.assert_array_equal(hi2, rhi, err_msg=name)
        np.testing.assert_array_equal(lo2, rlo, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_column_lanes_of_every_class_equal_the_reference(seed):
    for name, col in seeded_columns(seed).items():
        np.testing.assert_array_equal(K.hash_column(col), RK.hash_column(col), err_msg=name)
        for a, b in zip(K._column_lanes(col), RK._column_lanes(col)):
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("salt", [0, 9])
@pytest.mark.parametrize("register", [True, False])
def test_hash_values_against_plain_and_reference(fresh_registry, salt, register):
    cols = seeded_columns(salt)
    rows = [tuple(c[i] for c in cols.values()) for i in range(200)] + CORPUS_ROWS
    got = K.hash_values(rows, salt=salt, register=register)
    np.testing.assert_array_equal(got, K._hash_values_plain(rows, salt=salt, register=register))
    np.testing.assert_array_equal(got, RK.hash_values(rows, salt=salt, register=register))
    assert K.ref_scalar("a", 1, None, salt=salt) == RK.ref_scalar("a", 1, None, salt=salt)


@pytest.mark.parametrize("salt", [0, 3])
@pytest.mark.parametrize("register", [True, False])
def test_mix_columns_fused_against_mix_columns_and_reference(fresh_registry, salt, register):
    cols = seeded_columns(salt + 10)
    n = len(cols["str"])
    for names in (["str"], ["str", "mixed", "bytes"], ["str", "int64"], ["float64", "bool"]):
        arrs = [cols[c] for c in names]
        got = K.mix_columns_fused(arrs, n, salt=salt, register=register)
        np.testing.assert_array_equal(got, K.mix_columns(arrs, n, salt=salt, register=register),
                                      err_msg=str(names))
        np.testing.assert_array_equal(
            got, RK.mix_columns_fused(arrs, n, salt=salt, register=register), err_msg=str(names))


def test_all_unique_against_plain():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**63, 5000, dtype=np.uint64)
    for k in (keys, np.r_[keys, keys[17:18]], np.array([0, 5, 0], np.uint64),
              np.array([0, 5], np.uint64), keys[:1], keys[:0], keys[::2]):
        assert K.all_unique(k) == K.all_unique_plain(k) == RK.all_unique(k)


# -- the key registry ---------------------------------------------------------------------------


def test_native_registry_detects_a_lane_collision():
    reg = N.KeyRegistry(1000)
    lo = np.array([10, 20, 30], dtype=np.uint64)
    hi = np.array([1, 2, 3], dtype=np.uint64)
    assert reg.register(lo, hi) == -1
    assert reg.register(lo, hi) == -1  # the same keys again are fine
    assert reg.register(np.array([20], np.uint64), np.array([99], np.uint64)) == 0
    assert reg.stats() == (3, 0)


@pytest.mark.parametrize("registry", ["native", "plain"])
@pytest.mark.parametrize("allow", [False, True])
def test_registry_collision_and_cap_agree_with_plain(registry, allow):
    """The same batches give the same answers from the native registry and the dict version:
    a clash's index, the freeze at the cap, and past it the error or (``allow``) a pass."""
    cls = K._KeyRegistry if registry == "native" else K._KeyRegistryPlain
    reg = cls(8, allow=allow)
    lo = np.arange(100, 106, dtype=np.uint64)
    assert reg.register(lo, lo + np.uint64(1)) == -1
    assert not reg.frozen
    clash = np.array([7, 101, 102], dtype=np.uint64)
    assert reg.register(clash, np.array([1, 5, 103], np.uint64)) == 1  # 101 is known as 102
    more = np.arange(200, 204, dtype=np.uint64)  # the cap falls inside this batch
    if allow:
        assert reg.register(more, more) == -1
    else:
        with pytest.raises(K.KeyRegistryOverflowError, match="PATHWAY_KEY_REGISTRY_CAP"):
            reg.register(more, more)
    assert reg.frozen
    # frozen: known keys still detect a clash first, before the overflow
    assert reg.register(np.array([103, 999], np.uint64), np.array([0, 1], np.uint64)) == 0


def test_register_keys_raises_on_collision_and_at_the_cap(fresh_registry, monkeypatch):
    K._register_keys(np.array([77], np.uint64), np.array([1], np.uint64))
    with pytest.raises(K.KeyCollisionError, match="collision"):
        K._register_keys(np.array([77], np.uint64), np.array([2], np.uint64))
    monkeypatch.setattr(K, "_REGISTRY", None)
    monkeypatch.setenv("PATHWAY_KEY_REGISTRY_CAP", "3")
    with pytest.raises(K.KeyRegistryOverflowError):
        K.hash_values([(i,) for i in range(5)])
    monkeypatch.setattr(K, "_REGISTRY", None)
    monkeypatch.setenv("PATHWAY_KEY_REGISTRY_OVERFLOW", "allow")
    assert len(K.hash_values([(i,) for i in range(5)])) == 5


def test_mix_columns_fused_registers_its_keys(fresh_registry):
    words = np.array(["x1", "x2"], dtype=object)
    a = K.mix_columns_fused([words], 2)
    K.mix_columns([words], 2)  # the same keys, the same lanes: no clash
    with pytest.raises(K.KeyCollisionError):
        K._register_keys(np.ascontiguousarray(a[:1]), np.array([0xBAD], np.uint64))


# -- the slot map -------------------------------------------------------------------------------


def test_slot_map_order_equals_the_dict_version():
    rng = np.random.default_rng(11)
    native, plain = SlotMap(), SlotMapPlain()
    pool = rng.integers(0, 2**64 - 1, 3000, dtype=np.uint64)
    for step in range(20):
        keys = pool[rng.integers(0, 150 * (step + 1), 400)]
        got, n_new = native.lookup_or_insert(keys)
        want, want_new = plain.lookup_or_insert(keys)
        np.testing.assert_array_equal(got, want)
        assert n_new == want_new and len(native) == len(plain)
    probe = np.r_[pool[:50], rng.integers(0, 2**63, 50, dtype=np.uint64)]
    np.testing.assert_array_equal(native.lookup(probe), plain.lookup(probe))
    order = pool[np.sort(np.unique(pool, return_index=True)[1])][:10]
    rebuilt, rebuilt_plain = SlotMap.rebuild(order), SlotMapPlain.rebuild(order)
    assert type(rebuilt) is SlotMap and type(rebuilt_plain) is SlotMapPlain
    np.testing.assert_array_equal(rebuilt.lookup(order), np.arange(10))
    np.testing.assert_array_equal(rebuilt_plain.lookup(order), np.arange(10))
    with pytest.raises(ValueError, match="repeat"):
        SlotMap.rebuild(np.r_[order, order[:1]])


def test_slot_map_takes_non_contiguous_and_narrow_keys():
    keys = np.arange(40, dtype=np.int64)[::2]  # strided int64
    native, plain = SlotMap(), SlotMapPlain()
    np.testing.assert_array_equal(native.lookup_or_insert(keys)[0],
                                  plain.lookup_or_insert(keys)[0])
    np.testing.assert_array_equal(native.lookup(np.arange(5, dtype=np.uint32)),
                                  plain.lookup(np.arange(5, dtype=np.uint32)))
