/* Native runtime kernels for pathway_tpu_torch: the engine's keyspace on the host.
 *
 * Copy of pathway_tpu/native/native.c. Only the module's name changes, to
 * _pathway_torch_native (its PyModuleDef, its PyInit function and its types'
 * names), so that the two packages' extensions load side by side in one
 * process. The arithmetic is the reference's, so the port's keys are the
 * reference's keys bit for bit.
 *
 * Batch row hashing with EXACTLY the same scalar semantics as the pure-Python
 * implementation in engine/keys.py (splitmix64 avalanche folds over
 * per-scalar digests; strings/bytes via BLAKE2b-64 as
 * hashlib.blake2b(digest_size=8) produces), the key table behind
 * engine/slotmap.py and the key registry. Python and C paths agree
 * bit-for-bit (tests/test_torch_native.py).
 *
 * No call releases the interpreter's lock. The key table's and the key
 * registry's calls run no Python code, so each of them is one critical
 * section for the engine's worker threads; the hashing calls may run the
 * Python fallback for values they do not hash themselves.
 *
 * Built with the host C compiler against the CPython C API by
 * pathway_tpu_torch/native/__init__.py.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* ----------------------------------------------------------------- */
/* BLAKE2b (RFC 7693), fixed config: 8-byte digest, no key           */

static const uint64_t blake2b_iv[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

static const uint8_t blake2b_sigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

static inline uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

#define B2B_G(a, b, c, d, x, y)                 \
    do {                                        \
        v[a] = v[a] + v[b] + (x);               \
        v[d] = rotr64(v[d] ^ v[a], 32);         \
        v[c] = v[c] + v[d];                     \
        v[b] = rotr64(v[b] ^ v[c], 24);         \
        v[a] = v[a] + v[b] + (y);               \
        v[d] = rotr64(v[d] ^ v[a], 16);         \
        v[c] = v[c] + v[d];                     \
        v[b] = rotr64(v[b] ^ v[c], 63);         \
    } while (0)

static void blake2b_compress(uint64_t h[8], const uint8_t block[128],
                             uint64_t t, int last) {
    uint64_t v[16], m[16];
    int i, r;
    for (i = 0; i < 8; i++) v[i] = h[i];
    for (i = 0; i < 8; i++) v[i + 8] = blake2b_iv[i];
    v[12] ^= t; /* low counter word; inputs here are < 2^64 bytes */
    if (last) v[14] = ~v[14];
    for (i = 0; i < 16; i++) memcpy(&m[i], block + 8 * i, 8);
    for (r = 0; r < 12; r++) {
        const uint8_t *s = blake2b_sigma[r];
        B2B_G(0, 4, 8, 12, m[s[0]], m[s[1]]);
        B2B_G(1, 5, 9, 13, m[s[2]], m[s[3]]);
        B2B_G(2, 6, 10, 14, m[s[4]], m[s[5]]);
        B2B_G(3, 7, 11, 15, m[s[6]], m[s[7]]);
        B2B_G(0, 5, 10, 15, m[s[8]], m[s[9]]);
        B2B_G(1, 6, 11, 12, m[s[10]], m[s[11]]);
        B2B_G(2, 7, 8, 13, m[s[12]], m[s[13]]);
        B2B_G(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

/* 8-byte BLAKE2b digest of data, as little-endian uint64 (the exact value
 * of int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), 'little')) */
static uint64_t blake2b8(const uint8_t *data, Py_ssize_t len) {
    uint64_t h[8];
    uint8_t block[128];
    Py_ssize_t remaining = len, off = 0;
    memcpy(h, blake2b_iv, sizeof(h));
    h[0] ^= 0x01010000ULL ^ 8ULL; /* digest_size=8, no key, fanout=depth=1 */
    while (remaining > 128) {
        blake2b_compress(h, data + off, (uint64_t)(off + 128), 0);
        off += 128;
        remaining -= 128;
    }
    memset(block, 0, sizeof(block));
    if (remaining > 0) memcpy(block, data + off, (size_t)remaining);
    blake2b_compress(h, block, (uint64_t)len, 1);
    return h[0];
}

/* second 8 bytes (little-endian) of hashlib.blake2b(data, digest_size=16)
 * — the HI key lane for strings/bytes. A separate digest from blake2b8:
 * the blake2b parameter block folds the digest length into h[0], so the
 * 16-byte digest is independent of the 8-byte one (the lanes must not be
 * derivable from each other or low-lane collisions would always agree on
 * the high lane and conflation detection could never fire). */
static uint64_t blake2b16hi(const uint8_t *data, Py_ssize_t len) {
    uint64_t h[8];
    uint8_t block[128];
    Py_ssize_t remaining = len, off = 0;
    memcpy(h, blake2b_iv, sizeof(h));
    h[0] ^= 0x01010000ULL ^ 16ULL; /* digest_size=16 */
    while (remaining > 128) {
        blake2b_compress(h, data + off, (uint64_t)(off + 128), 0);
        off += 128;
        remaining -= 128;
    }
    memset(block, 0, sizeof(block));
    if (remaining > 0) memcpy(block, data + off, (size_t)remaining);
    blake2b_compress(h, block, (uint64_t)len, 1);
    return h[1];
}

/* ----------------------------------------------------------------- */
/* splitmix64 finalizer — must match keys._splitmix exactly           */

static inline uint64_t splitmix(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

#define NONE_TAG 0x736E6F6E65736E6FULL
#define TUPLE_SEED 0x9E37ULL
#define ROW_SEED 0xA0761D6478BD642FULL

/* HI key lane (the upper 64 bits of the 128-bit keyspace): same scalar
 * taxonomy as the LO lane but mixed with an independent finalizer
 * (moremur constants) so the lanes never co-collide. Must match
 * keys._hash_scalar_hi / keys._splitmix2 bit-for-bit. */
#define NONE_TAG_HI 0x6E6F6E655F686921ULL
#define TUPLE_SEED_HI 0xD1B5ULL
#define ROW_SEED_HI 0xE7037ED1A0B428DBULL

static inline uint64_t splitmix2(uint64_t x) {
    x += 0xD1B54A32D192ED03ULL;
    x = (x ^ (x >> 32)) * 0xAEF17502108EF2D9ULL;
    x = (x ^ (x >> 29)) * 0xD1342543DE82EF95ULL;
    return x ^ (x >> 32);
}

/* hash one scalar with keys._hash_scalar semantics; `fallback` is the
 * Python implementation used for types this C path doesn't know
 * (ndarrays, datetimes, Json wrappers, ...). Returns 0 + sets err on
 * failure. */
static int hash_scalar(PyObject *v, PyObject *fallback, uint64_t *out) {
    if (v == Py_None) {
        *out = NONE_TAG;
        return 0;
    }
    if (PyBool_Check(v)) {
        *out = splitmix((v == Py_True ? 1ULL : 0ULL) + 0xB001ULL);
        return 0;
    }
    if (PyLong_CheckExact(v)) {
        uint64_t x = PyLong_AsUnsignedLongLongMask(v); /* low 64 bits */
        if (x == (uint64_t)-1 && PyErr_Occurred()) return -1;
        *out = splitmix(x);
        return 0;
    }
    if (PyFloat_CheckExact(v)) {
        double d = PyFloat_AS_DOUBLE(v);
        uint64_t bits;
        memcpy(&bits, &d, 8);
        *out = splitmix(bits);
        return 0;
    }
    if (PyUnicode_CheckExact(v)) {
        Py_ssize_t len;
        const char *utf8 = PyUnicode_AsUTF8AndSize(v, &len);
        if (utf8 == NULL) return -1;
        *out = blake2b8((const uint8_t *)utf8, len);
        return 0;
    }
    if (PyBytes_CheckExact(v)) {
        *out = blake2b8((const uint8_t *)PyBytes_AS_STRING(v),
                        PyBytes_GET_SIZE(v));
        return 0;
    }
    if (PyTuple_CheckExact(v)) {
        uint64_t acc = TUPLE_SEED, h;
        Py_ssize_t i, n = PyTuple_GET_SIZE(v);
        for (i = 0; i < n; i++) {
            if (hash_scalar(PyTuple_GET_ITEM(v, i), fallback, &h) < 0)
                return -1;
            acc = splitmix(acc ^ h);
        }
        *out = acc;
        return 0;
    }
    /* numpy scalars, ndarrays, datetimes, wrappers: defer to Python */
    {
        PyObject *res = PyObject_CallFunctionObjArgs(fallback, v, NULL);
        uint64_t x;
        if (res == NULL) return -1;
        x = PyLong_AsUnsignedLongLongMask(res);
        Py_DECREF(res);
        if (x == (uint64_t)-1 && PyErr_Occurred()) return -1;
        *out = x;
        return 0;
    }
}

/* hash one scalar on BOTH key lanes. fb_lo/fb_hi are the Python fallback
 * implementations for types this C path doesn't know. */
static int hash_scalar2(PyObject *v, PyObject *fb_lo, PyObject *fb_hi,
                        uint64_t *lo, uint64_t *hi) {
    if (v == Py_None) {
        *lo = NONE_TAG;
        *hi = NONE_TAG_HI;
        return 0;
    }
    if (PyBool_Check(v)) {
        uint64_t x = (v == Py_True ? 1ULL : 0ULL) + 0xB001ULL;
        *lo = splitmix(x);
        *hi = splitmix2(x);
        return 0;
    }
    if (PyLong_CheckExact(v)) {
        uint64_t x = PyLong_AsUnsignedLongLongMask(v);
        if (x == (uint64_t)-1 && PyErr_Occurred()) return -1;
        *lo = splitmix(x);
        *hi = splitmix2(x);
        return 0;
    }
    if (PyFloat_CheckExact(v)) {
        double d = PyFloat_AS_DOUBLE(v);
        uint64_t bits;
        memcpy(&bits, &d, 8);
        *lo = splitmix(bits);
        *hi = splitmix2(bits);
        return 0;
    }
    if (PyUnicode_CheckExact(v)) {
        Py_ssize_t len;
        const char *utf8 = PyUnicode_AsUTF8AndSize(v, &len);
        if (utf8 == NULL) return -1;
        *lo = blake2b8((const uint8_t *)utf8, len);
        *hi = blake2b16hi((const uint8_t *)utf8, len);
        return 0;
    }
    if (PyBytes_CheckExact(v)) {
        *lo = blake2b8((const uint8_t *)PyBytes_AS_STRING(v),
                       PyBytes_GET_SIZE(v));
        *hi = blake2b16hi((const uint8_t *)PyBytes_AS_STRING(v),
                          PyBytes_GET_SIZE(v));
        return 0;
    }
    if (PyTuple_CheckExact(v)) {
        uint64_t acc_lo = TUPLE_SEED, acc_hi = TUPLE_SEED_HI, l, h;
        Py_ssize_t i, n = PyTuple_GET_SIZE(v);
        for (i = 0; i < n; i++) {
            if (hash_scalar2(PyTuple_GET_ITEM(v, i), fb_lo, fb_hi, &l, &h) < 0)
                return -1;
            acc_lo = splitmix(acc_lo ^ l);
            acc_hi = splitmix2(acc_hi ^ h);
        }
        *lo = acc_lo;
        *hi = acc_hi;
        return 0;
    }
    {
        PyObject *res = PyObject_CallFunctionObjArgs(fb_lo, v, NULL);
        uint64_t x;
        if (res == NULL) return -1;
        x = PyLong_AsUnsignedLongLongMask(res);
        Py_DECREF(res);
        if (x == (uint64_t)-1 && PyErr_Occurred()) return -1;
        *lo = x;
        res = PyObject_CallFunctionObjArgs(fb_hi, v, NULL);
        if (res == NULL) return -1;
        x = PyLong_AsUnsignedLongLongMask(res);
        Py_DECREF(res);
        if (x == (uint64_t)-1 && PyErr_Occurred()) return -1;
        *hi = x;
        return 0;
    }
}

#define STR_MEMO_CAP 65536

/* memoized two-lane hash of an exact str: the stream hot path hashes the
 * same (equal-valued) words every tick — a dict probe (~40ns) replaces
 * two BLAKE2b digests (~600ns). memo may be NULL. */
static int hash_scalar2_memo(PyObject *v, PyObject *fb_lo, PyObject *fb_hi,
                             PyObject *memo, uint64_t *lo, uint64_t *hi) {
    PyObject *hit, *pair, *plo, *phi;
    if (memo == NULL || !PyUnicode_CheckExact(v))
        return hash_scalar2(v, fb_lo, fb_hi, lo, hi);
    hit = PyDict_GetItemWithError(memo, v); /* borrowed */
    if (hit != NULL) {
        *lo = PyLong_AsUnsignedLongLongMask(PyTuple_GET_ITEM(hit, 0));
        *hi = PyLong_AsUnsignedLongLongMask(PyTuple_GET_ITEM(hit, 1));
        return 0;
    }
    if (PyErr_Occurred()) return -1;
    if (hash_scalar2(v, fb_lo, fb_hi, lo, hi) < 0) return -1;
    if (PyDict_GET_SIZE(memo) >= STR_MEMO_CAP) PyDict_Clear(memo);
    plo = PyLong_FromUnsignedLongLong(*lo);
    phi = PyLong_FromUnsignedLongLong(*hi);
    if (plo == NULL || phi == NULL) {
        Py_XDECREF(plo); Py_XDECREF(phi);
        return -1;
    }
    pair = PyTuple_Pack(2, plo, phi);
    Py_DECREF(plo); Py_DECREF(phi);
    if (pair == NULL) return -1;
    if (PyDict_SetItem(memo, v, pair) < 0) {
        Py_DECREF(pair);
        return -1;
    }
    Py_DECREF(pair);
    return 0;
}

/* hash_scalars2(values, fb_lo, fb_hi, memo_or_None,
 *               out_lo_u64, out_hi_u64) -> None */
static PyObject *py_hash_scalars2(PyObject *self, PyObject *args) {
    PyObject *values, *fb_lo, *fb_hi, *memo, *lo_obj, *hi_obj;
    Py_buffer lo, hi;
    (void)self;
    if (!PyArg_ParseTuple(args, "OOOOOO", &values, &fb_lo, &fb_hi, &memo,
                          &lo_obj, &hi_obj))
        return NULL;
    if (memo == Py_None) memo = NULL;
    if (PyObject_GetBuffer(lo_obj, &lo, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    if (PyObject_GetBuffer(hi_obj, &hi, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&lo);
        return NULL;
    }
    {
        PyObject *seq = PySequence_Fast(values, "values must be a sequence");
        Py_ssize_t n, i;
        uint64_t *dlo = (uint64_t *)lo.buf, *dhi = (uint64_t *)hi.buf;
        if (seq == NULL) goto fail;
        n = PySequence_Fast_GET_SIZE(seq);
        if ((Py_ssize_t)(lo.len / 8) < n || (Py_ssize_t)(hi.len / 8) < n) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_ValueError, "output buffer too small");
            goto fail;
        }
        for (i = 0; i < n; i++) {
            if (hash_scalar2_memo(PySequence_Fast_GET_ITEM(seq, i), fb_lo,
                                  fb_hi, memo, &dlo[i], &dhi[i]) < 0) {
                Py_DECREF(seq);
                goto fail;
            }
        }
        Py_DECREF(seq);
    }
    PyBuffer_Release(&lo);
    PyBuffer_Release(&hi);
    Py_RETURN_NONE;
fail:
    PyBuffer_Release(&lo);
    PyBuffer_Release(&hi);
    return NULL;
}

/* mix_cols2(cols, n, salt_lo, salt_hi, fb_lo, fb_hi, memo_or_None,
 *           out_lo_u64, out_hi_u64) -> None
 * Fused column-key fold for the columnar ingest plane: accumulate every
 * OBJECT column of a batch into both key lanes in one C pass —
 * out[i] starts at ROW_SEED ^ salt and folds splitmix(acc ^ lane(v))
 * per column, which is keys.mix_columns' per-column _column_lanes fold
 * (and therefore hash_rows2 over the corresponding row tuples)
 * bit-for-bit, without materializing per-column lane arrays or row
 * tuples. Strings ride the same value-level memo as hash_rows2. */
static PyObject *py_mix_cols2(PyObject *self, PyObject *args) {
    PyObject *cols, *fb_lo, *fb_hi, *memo, *lo_obj, *hi_obj;
    unsigned long long salt_lo, salt_hi;
    Py_ssize_t n;
    Py_buffer lo, hi;
    (void)self;
    if (!PyArg_ParseTuple(args, "OnKKOOOOO", &cols, &n, &salt_lo, &salt_hi,
                          &fb_lo, &fb_hi, &memo, &lo_obj, &hi_obj))
        return NULL;
    if (memo == Py_None) memo = NULL;
    if (PyObject_GetBuffer(lo_obj, &lo, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    if (PyObject_GetBuffer(hi_obj, &hi, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&lo);
        return NULL;
    }
    {
        PyObject *colseq = PySequence_Fast(cols, "cols must be a sequence");
        Py_ssize_t ncols, c, i;
        uint64_t *dlo = (uint64_t *)lo.buf, *dhi = (uint64_t *)hi.buf;
        if (colseq == NULL) goto fail;
        ncols = PySequence_Fast_GET_SIZE(colseq);
        if ((Py_ssize_t)(lo.len / 8) < n || (Py_ssize_t)(hi.len / 8) < n) {
            Py_DECREF(colseq);
            PyErr_SetString(PyExc_ValueError, "output buffer too small");
            goto fail;
        }
        for (i = 0; i < n; i++) {
            dlo[i] = ROW_SEED ^ (uint64_t)salt_lo;
            dhi[i] = ROW_SEED_HI ^ (uint64_t)salt_hi;
        }
        for (c = 0; c < ncols; c++) {
            PyObject *col = PySequence_Fast_GET_ITEM(colseq, c);
            PyObject *vals = PySequence_Fast(col, "column must be a sequence");
            uint64_t l, h;
            if (vals == NULL) {
                Py_DECREF(colseq);
                goto fail;
            }
            if (PySequence_Fast_GET_SIZE(vals) != n) {
                Py_DECREF(vals);
                Py_DECREF(colseq);
                PyErr_SetString(PyExc_ValueError,
                                "column length != row count");
                goto fail;
            }
            for (i = 0; i < n; i++) {
                if (hash_scalar2_memo(PySequence_Fast_GET_ITEM(vals, i),
                                      fb_lo, fb_hi, memo, &l, &h) < 0) {
                    Py_DECREF(vals);
                    Py_DECREF(colseq);
                    goto fail;
                }
                dlo[i] = splitmix(dlo[i] ^ l);
                dhi[i] = splitmix2(dhi[i] ^ h);
            }
            Py_DECREF(vals);
        }
        Py_DECREF(colseq);
    }
    PyBuffer_Release(&lo);
    PyBuffer_Release(&hi);
    Py_RETURN_NONE;
fail:
    PyBuffer_Release(&lo);
    PyBuffer_Release(&hi);
    return NULL;
}

/* hash_rows2(rows, salt_lo, salt_hi, fb_lo, fb_hi, memo_or_None,
 *            out_lo_u64, out_hi_u64) -> None — both key lanes per row */
static PyObject *py_hash_rows2(PyObject *self, PyObject *args) {
    PyObject *rows, *fb_lo, *fb_hi, *memo, *lo_obj, *hi_obj;
    unsigned long long salt_lo, salt_hi;
    Py_buffer lo, hi;
    (void)self;
    if (!PyArg_ParseTuple(args, "OKKOOOOO", &rows, &salt_lo, &salt_hi,
                          &fb_lo, &fb_hi, &memo, &lo_obj, &hi_obj))
        return NULL;
    if (memo == Py_None) memo = NULL;
    if (PyObject_GetBuffer(lo_obj, &lo, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    if (PyObject_GetBuffer(hi_obj, &hi, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&lo);
        return NULL;
    }
    {
        PyObject *seq = PySequence_Fast(rows, "rows must be a sequence");
        Py_ssize_t n, i;
        uint64_t *dlo = (uint64_t *)lo.buf, *dhi = (uint64_t *)hi.buf;
        if (seq == NULL) goto fail;
        n = PySequence_Fast_GET_SIZE(seq);
        if ((Py_ssize_t)(lo.len / 8) < n || (Py_ssize_t)(hi.len / 8) < n) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_ValueError, "output buffer too small");
            goto fail;
        }
        for (i = 0; i < n; i++) {
            PyObject *row = PySequence_Fast_GET_ITEM(seq, i);
            uint64_t acc_lo = ROW_SEED ^ (uint64_t)salt_lo;
            uint64_t acc_hi = ROW_SEED_HI ^ (uint64_t)salt_hi;
            uint64_t l, h;
            Py_ssize_t j, m;
            PyObject *rowseq = PySequence_Fast(row, "row must be a sequence");
            if (rowseq == NULL) {
                Py_DECREF(seq);
                goto fail;
            }
            m = PySequence_Fast_GET_SIZE(rowseq);
            for (j = 0; j < m; j++) {
                if (hash_scalar2_memo(PySequence_Fast_GET_ITEM(rowseq, j),
                                      fb_lo, fb_hi, memo, &l, &h) < 0) {
                    Py_DECREF(rowseq);
                    Py_DECREF(seq);
                    goto fail;
                }
                acc_lo = splitmix(acc_lo ^ l);
                acc_hi = splitmix2(acc_hi ^ h);
            }
            Py_DECREF(rowseq);
            dlo[i] = acc_lo;
            dhi[i] = acc_hi;
        }
        Py_DECREF(seq);
    }
    PyBuffer_Release(&lo);
    PyBuffer_Release(&hi);
    Py_RETURN_NONE;
fail:
    PyBuffer_Release(&lo);
    PyBuffer_Release(&hi);
    return NULL;
}

/* splitmix64_2(x: int) -> int — HI-lane finalizer, for parity tests */
static PyObject *py_splitmix2(PyObject *self, PyObject *arg) {
    unsigned long long x = PyLong_AsUnsignedLongLongMask(arg);
    (void)self;
    if (x == (unsigned long long)-1 && PyErr_Occurred()) return NULL;
    return PyLong_FromUnsignedLongLong(splitmix2(x));
}

/* blake2b16hi(data) -> int — HI string lane, for parity tests */
static PyObject *py_blake2b16hi(PyObject *self, PyObject *arg) {
    Py_buffer buf;
    uint64_t h;
    (void)self;
    if (PyObject_GetBuffer(arg, &buf, PyBUF_C_CONTIGUOUS) < 0) return NULL;
    h = blake2b16hi((const uint8_t *)buf.buf, buf.len);
    PyBuffer_Release(&buf);
    return PyLong_FromUnsignedLongLong(h);
}

/* hash_rows(rows: sequence of tuples, salt: int, fallback, out: writable
 * uint64 buffer of len(rows)) -> None */
static PyObject *py_hash_rows(PyObject *self, PyObject *args) {
    PyObject *rows, *fallback, *out_obj;
    unsigned long long salt;
    Py_buffer out;
    (void)self;
    if (!PyArg_ParseTuple(args, "OKOO", &rows, &salt, &fallback, &out_obj))
        return NULL;
    if (PyObject_GetBuffer(out_obj, &out, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    {
        PyObject *seq = PySequence_Fast(rows, "rows must be a sequence");
        Py_ssize_t n, i;
        uint64_t *dst = (uint64_t *)out.buf;
        if (seq == NULL) {
            PyBuffer_Release(&out);
            return NULL;
        }
        n = PySequence_Fast_GET_SIZE(seq);
        if ((Py_ssize_t)(out.len / 8) < n) {
            Py_DECREF(seq);
            PyBuffer_Release(&out);
            PyErr_SetString(PyExc_ValueError, "output buffer too small");
            return NULL;
        }
        for (i = 0; i < n; i++) {
            PyObject *row = PySequence_Fast_GET_ITEM(seq, i);
            uint64_t acc = ROW_SEED ^ (uint64_t)salt, h;
            Py_ssize_t j, m;
            PyObject *rowseq = PySequence_Fast(row, "row must be a sequence");
            if (rowseq == NULL) {
                Py_DECREF(seq);
                PyBuffer_Release(&out);
                return NULL;
            }
            m = PySequence_Fast_GET_SIZE(rowseq);
            for (j = 0; j < m; j++) {
                if (hash_scalar(PySequence_Fast_GET_ITEM(rowseq, j),
                                fallback, &h) < 0) {
                    Py_DECREF(rowseq);
                    Py_DECREF(seq);
                    PyBuffer_Release(&out);
                    return NULL;
                }
                acc = splitmix(acc ^ h);
            }
            Py_DECREF(rowseq);
            dst[i] = acc;
        }
        Py_DECREF(seq);
    }
    PyBuffer_Release(&out);
    Py_RETURN_NONE;
}

/* memoized LO-lane hash of an exact str (see hash_scalar2_memo) */
static int hash_scalar_memo(PyObject *v, PyObject *fallback, PyObject *memo,
                            uint64_t *out) {
    PyObject *hit, *plo;
    if (memo == NULL || !PyUnicode_CheckExact(v))
        return hash_scalar(v, fallback, out);
    hit = PyDict_GetItemWithError(memo, v); /* borrowed */
    if (hit != NULL) {
        *out = PyLong_AsUnsignedLongLongMask(hit);
        return 0;
    }
    if (PyErr_Occurred()) return -1;
    if (hash_scalar(v, fallback, out) < 0) return -1;
    if (PyDict_GET_SIZE(memo) >= STR_MEMO_CAP) PyDict_Clear(memo);
    plo = PyLong_FromUnsignedLongLong(*out);
    if (plo == NULL) return -1;
    if (PyDict_SetItem(memo, v, plo) < 0) {
        Py_DECREF(plo);
        return -1;
    }
    Py_DECREF(plo);
    return 0;
}

/* hash_scalars(values: sequence, fallback, out: writable uint64 buffer
 * [, memo_dict]) -> None — per-element hash_scalar (group-key/hash_column
 * hot path; the optional memo caches string digests value-wise) */
static PyObject *py_hash_scalars(PyObject *self, PyObject *args) {
    PyObject *values, *fallback, *out_obj, *memo = NULL;
    Py_buffer out;
    (void)self;
    if (!PyArg_ParseTuple(args, "OOO|O", &values, &fallback, &out_obj, &memo))
        return NULL;
    if (memo == Py_None) memo = NULL;
    if (PyObject_GetBuffer(out_obj, &out, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    {
        PyObject *seq = PySequence_Fast(values, "values must be a sequence");
        Py_ssize_t n, i;
        uint64_t *dst = (uint64_t *)out.buf;
        if (seq == NULL) {
            PyBuffer_Release(&out);
            return NULL;
        }
        n = PySequence_Fast_GET_SIZE(seq);
        if ((Py_ssize_t)(out.len / 8) < n) {
            Py_DECREF(seq);
            PyBuffer_Release(&out);
            PyErr_SetString(PyExc_ValueError, "output buffer too small");
            return NULL;
        }
        for (i = 0; i < n; i++) {
            if (hash_scalar_memo(PySequence_Fast_GET_ITEM(seq, i), fallback,
                                 memo, &dst[i]) < 0) {
                Py_DECREF(seq);
                PyBuffer_Release(&out);
                return NULL;
            }
        }
        Py_DECREF(seq);
    }
    PyBuffer_Release(&out);
    Py_RETURN_NONE;
}

/* blake2b8(data: bytes-like) -> int — exposed for parity tests */
static PyObject *py_blake2b8(PyObject *self, PyObject *arg) {
    Py_buffer buf;
    uint64_t h;
    (void)self;
    if (PyObject_GetBuffer(arg, &buf, PyBUF_C_CONTIGUOUS) < 0) return NULL;
    h = blake2b8((const uint8_t *)buf.buf, buf.len);
    PyBuffer_Release(&buf);
    return PyLong_FromUnsignedLongLong(h);
}

/* splitmix64(x: int) -> int — exposed for parity tests */
static PyObject *py_splitmix(PyObject *self, PyObject *arg) {
    unsigned long long x = PyLong_AsUnsignedLongLongMask(arg);
    (void)self;
    if (x == (unsigned long long)-1 && PyErr_Occurred()) return NULL;
    return PyLong_FromUnsignedLongLong(splitmix(x));
}

/* ----------------------------------------------------------------- */
/* KeyTable — open-addressing uint64 -> slot map with batch lookups.  */
/* Powers the dense groupby arena and join state: slot ids are dense  */
/* row indices into columnar (numpy) state arrays, so per-key state   */
/* updates become vectorized array ops instead of Python dict churn   */
/* (the role differential arrangements play in the reference).        */

typedef struct {
    PyObject_HEAD
    uint64_t *keys;
    int64_t *slots;
    uint8_t *used;
    Py_ssize_t capacity; /* power of two */
    Py_ssize_t size;
    int64_t next_slot;
} KeyTableObject;

static int keytable_grow(KeyTableObject *t, Py_ssize_t min_capacity) {
    Py_ssize_t new_cap = t->capacity ? t->capacity : 64;
    uint64_t *nk;
    int64_t *ns;
    uint8_t *nu;
    Py_ssize_t i;
    while (new_cap < min_capacity) new_cap <<= 1;
    nk = (uint64_t *)malloc((size_t)new_cap * 8);
    ns = (int64_t *)malloc((size_t)new_cap * 8);
    nu = (uint8_t *)calloc((size_t)new_cap, 1);
    if (!nk || !ns || !nu) {
        free(nk); free(ns); free(nu);
        PyErr_NoMemory();
        return -1;
    }
    for (i = 0; i < t->capacity; i++) {
        if (t->used[i]) {
            uint64_t h = splitmix(t->keys[i]);
            Py_ssize_t j = (Py_ssize_t)(h & (uint64_t)(new_cap - 1));
            while (nu[j]) j = (j + 1) & (new_cap - 1);
            nu[j] = 1;
            nk[j] = t->keys[i];
            ns[j] = t->slots[i];
        }
    }
    free(t->keys); free(t->slots); free(t->used);
    t->keys = nk; t->slots = ns; t->used = nu;
    t->capacity = new_cap;
    return 0;
}

/* lookup_or_insert(keys: uint64 buffer, out: int64 buffer) -> n_new */
static PyObject *keytable_lookup_or_insert(PyObject *self, PyObject *args) {
    KeyTableObject *t = (KeyTableObject *)self;
    PyObject *keys_obj, *out_obj;
    Py_buffer keys, out;
    Py_ssize_t n, i, n_new = 0;
    if (!PyArg_ParseTuple(args, "OO", &keys_obj, &out_obj)) return NULL;
    if (PyObject_GetBuffer(keys_obj, &keys, PyBUF_C_CONTIGUOUS) < 0) return NULL;
    if (PyObject_GetBuffer(out_obj, &out, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&keys);
        return NULL;
    }
    n = keys.len / 8;
    if (out.len / 8 < n) {
        PyBuffer_Release(&keys); PyBuffer_Release(&out);
        PyErr_SetString(PyExc_ValueError, "output buffer too small");
        return NULL;
    }
    /* worst case inserts all n keys; keep load factor under 0.7 */
    if ((t->size + n) * 10 >= t->capacity * 7) {
        if (keytable_grow(t, (t->size + n) * 2) < 0) {
            PyBuffer_Release(&keys); PyBuffer_Release(&out);
            return NULL;
        }
    }
    {
        const uint64_t *src = (const uint64_t *)keys.buf;
        int64_t *dst = (int64_t *)out.buf;
        uint64_t mask = (uint64_t)(t->capacity - 1);
        for (i = 0; i < n; i++) {
            uint64_t k = src[i];
            Py_ssize_t j = (Py_ssize_t)(splitmix(k) & mask);
            while (t->used[j] && t->keys[j] != k) j = (j + 1) & mask;
            if (!t->used[j]) {
                t->used[j] = 1;
                t->keys[j] = k;
                t->slots[j] = t->next_slot++;
                t->size++;
                n_new++;
            }
            dst[i] = t->slots[j];
        }
    }
    PyBuffer_Release(&keys);
    PyBuffer_Release(&out);
    return PyLong_FromSsize_t(n_new);
}

/* lookup(keys: uint64 buffer, out: int64 buffer) -> None; missing = -1 */
static PyObject *keytable_lookup(PyObject *self, PyObject *args) {
    KeyTableObject *t = (KeyTableObject *)self;
    PyObject *keys_obj, *out_obj;
    Py_buffer keys, out;
    Py_ssize_t n, i;
    if (!PyArg_ParseTuple(args, "OO", &keys_obj, &out_obj)) return NULL;
    if (PyObject_GetBuffer(keys_obj, &keys, PyBUF_C_CONTIGUOUS) < 0) return NULL;
    if (PyObject_GetBuffer(out_obj, &out, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&keys);
        return NULL;
    }
    n = keys.len / 8;
    if (out.len / 8 < n) {
        PyBuffer_Release(&keys); PyBuffer_Release(&out);
        PyErr_SetString(PyExc_ValueError, "output buffer too small");
        return NULL;
    }
    if (t->capacity == 0) {
        int64_t *dst = (int64_t *)out.buf;
        for (i = 0; i < n; i++) dst[i] = -1;
    } else {
        const uint64_t *src = (const uint64_t *)keys.buf;
        int64_t *dst = (int64_t *)out.buf;
        uint64_t mask = (uint64_t)(t->capacity - 1);
        for (i = 0; i < n; i++) {
            uint64_t k = src[i];
            Py_ssize_t j = (Py_ssize_t)(splitmix(k) & mask);
            while (t->used[j] && t->keys[j] != k) j = (j + 1) & mask;
            dst[i] = t->used[j] ? t->slots[j] : -1;
        }
    }
    PyBuffer_Release(&keys);
    PyBuffer_Release(&out);
    Py_RETURN_NONE;
}

static Py_ssize_t keytable_len(PyObject *self) {
    return ((KeyTableObject *)self)->size;
}

static void keytable_dealloc(PyObject *self) {
    KeyTableObject *t = (KeyTableObject *)self;
    free(t->keys); free(t->slots); free(t->used);
    Py_TYPE(self)->tp_free(self);
}

static PyObject *keytable_new(PyTypeObject *type, PyObject *args,
                              PyObject *kwds) {
    KeyTableObject *t;
    (void)args; (void)kwds;
    t = (KeyTableObject *)type->tp_alloc(type, 0);
    if (t == NULL) return NULL;
    t->keys = NULL; t->slots = NULL; t->used = NULL;
    t->capacity = 0; t->size = 0; t->next_slot = 0;
    return (PyObject *)t;
}

static PyMethodDef keytable_methods[] = {
    {"lookup_or_insert", keytable_lookup_or_insert, METH_VARARGS,
     "lookup_or_insert(keys_u64, out_i64) -> n_new"},
    {"lookup", keytable_lookup, METH_VARARGS,
     "lookup(keys_u64, out_i64); missing -> -1"},
    {NULL, NULL, 0, NULL},
};

static PySequenceMethods keytable_as_sequence = {
    keytable_len, /* sq_length */
};

static PyTypeObject KeyTableType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_pathway_torch_native.KeyTable",
    .tp_basicsize = sizeof(KeyTableObject),
    .tp_dealloc = keytable_dealloc,
    .tp_as_sequence = &keytable_as_sequence,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "open-addressing uint64 -> dense slot map (batch API)",
    .tp_methods = keytable_methods,
    .tp_new = keytable_new,
};

/* ----------------------------------------------------------------- */
/* KeyRegistry — process-wide LO->HI lane map for 128-bit key          */
/* conflation detection. Keys are created as 128-bit values (two       */
/* independent lanes); the engine transports the LO lane in its        */
/* vectorized uint64 arrays, and every key-creation batch registers    */
/* (lo, hi) here: a lo that re-registers with a DIFFERENT hi is two    */
/* distinct 128-bit keys colliding on the transport lane — fail-stop   */
/* instead of silent row conflation (reference keys by the full u128,  */
/* value.rs:30-47, so it never conflates; we detect at the same        */
/* probability scale). Bounded: at cap the registry freezes (existing  */
/* entries still detect; new keys pass unchecked) — callers log once.  */

typedef struct {
    PyObject_HEAD
    uint64_t *keys;
    uint64_t *his;
    uint8_t *used;
    Py_ssize_t capacity; /* power of two */
    Py_ssize_t size;
    Py_ssize_t max_entries;
    int frozen;
} KeyRegistryObject;

static int keyregistry_grow(KeyRegistryObject *t, Py_ssize_t min_capacity) {
    Py_ssize_t new_cap = t->capacity ? t->capacity : 1024;
    uint64_t *nk, *nh;
    uint8_t *nu;
    Py_ssize_t i;
    while (new_cap < min_capacity) new_cap <<= 1;
    nk = (uint64_t *)malloc((size_t)new_cap * 8);
    nh = (uint64_t *)malloc((size_t)new_cap * 8);
    nu = (uint8_t *)calloc((size_t)new_cap, 1);
    if (!nk || !nh || !nu) {
        free(nk); free(nh); free(nu);
        PyErr_NoMemory();
        return -1;
    }
    for (i = 0; i < t->capacity; i++) {
        if (t->used[i]) {
            uint64_t h = splitmix(t->keys[i]);
            Py_ssize_t j = (Py_ssize_t)(h & (uint64_t)(new_cap - 1));
            while (nu[j]) j = (j + 1) & (new_cap - 1);
            nu[j] = 1;
            nk[j] = t->keys[i];
            nh[j] = t->his[i];
        }
    }
    free(t->keys); free(t->his); free(t->used);
    t->keys = nk; t->his = nh; t->used = nu;
    t->capacity = new_cap;
    return 0;
}

/* register(lo_u64_buf, hi_u64_buf) -> first conflicting index or -1 */
static PyObject *keyregistry_register(PyObject *self, PyObject *args) {
    KeyRegistryObject *t = (KeyRegistryObject *)self;
    PyObject *lo_obj, *hi_obj;
    Py_buffer lo, hi;
    Py_ssize_t n, i, conflict = -1;
    if (!PyArg_ParseTuple(args, "OO", &lo_obj, &hi_obj)) return NULL;
    if (PyObject_GetBuffer(lo_obj, &lo, PyBUF_C_CONTIGUOUS) < 0) return NULL;
    if (PyObject_GetBuffer(hi_obj, &hi, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&lo);
        return NULL;
    }
    n = lo.len / 8;
    if (hi.len / 8 < n) {
        PyBuffer_Release(&lo); PyBuffer_Release(&hi);
        PyErr_SetString(PyExc_ValueError, "hi buffer too small");
        return NULL;
    }
    if (!t->frozen && (t->size + n) * 10 >= t->capacity * 7) {
        /* clamp to 2x the entry cap: the insert loop freezes at
         * max_entries, so load factor stays <= 0.5 in the frozen table */
        Py_ssize_t want = (t->size + n) * 2;
        if (want > t->max_entries * 2) want = t->max_entries * 2;
        if (want > t->capacity && keyregistry_grow(t, want) < 0) {
            PyBuffer_Release(&lo); PyBuffer_Release(&hi);
            return NULL;
        }
    }
    if (t->capacity) {
        const uint64_t *slo = (const uint64_t *)lo.buf;
        const uint64_t *shi = (const uint64_t *)hi.buf;
        uint64_t mask = (uint64_t)(t->capacity - 1);
        for (i = 0; i < n; i++) {
            uint64_t k = slo[i];
            Py_ssize_t j = (Py_ssize_t)(splitmix(k) & mask);
            while (t->used[j] && t->keys[j] != k) j = (j + 1) & mask;
            if (t->used[j]) {
                if (t->his[j] != shi[i]) {
                    conflict = i;
                    break;
                }
            } else if (!t->frozen) {
                t->used[j] = 1;
                t->keys[j] = k;
                t->his[j] = shi[i];
                t->size++;
                if (t->size >= t->max_entries) t->frozen = 1;
            }
        }
    }
    PyBuffer_Release(&lo);
    PyBuffer_Release(&hi);
    return PyLong_FromSsize_t(conflict);
}

/* register_overflow(lo_u64_buf, hi_u64_buf, miss_u8_buf)
 *   -> first conflicting index or -1
 * Two-tier variant of register(): identical insert/detect behavior for
 * the hot in-memory table, but once the table is FROZEN (cap reached),
 * keys absent from it are NOT silently passed — miss[i] is set to 1 and
 * the caller (engine/keys.py) probes/inserts them in the spilled cold
 * tier. miss must be a writable byte buffer of at least n entries; only
 * miss indexes of absent-while-frozen keys are written (caller zeroes). */
static PyObject *keyregistry_register_overflow(PyObject *self, PyObject *args) {
    KeyRegistryObject *t = (KeyRegistryObject *)self;
    PyObject *lo_obj, *hi_obj, *miss_obj;
    Py_buffer lo, hi, miss;
    Py_ssize_t n, i, conflict = -1;
    if (!PyArg_ParseTuple(args, "OOO", &lo_obj, &hi_obj, &miss_obj))
        return NULL;
    if (PyObject_GetBuffer(lo_obj, &lo, PyBUF_C_CONTIGUOUS) < 0) return NULL;
    if (PyObject_GetBuffer(hi_obj, &hi, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&lo);
        return NULL;
    }
    if (PyObject_GetBuffer(miss_obj, &miss,
                           PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) < 0) {
        PyBuffer_Release(&lo); PyBuffer_Release(&hi);
        return NULL;
    }
    n = lo.len / 8;
    if (hi.len / 8 < n || miss.len < n) {
        PyBuffer_Release(&lo); PyBuffer_Release(&hi); PyBuffer_Release(&miss);
        PyErr_SetString(PyExc_ValueError, "hi/miss buffer too small");
        return NULL;
    }
    if (!t->frozen && (t->size + n) * 10 >= t->capacity * 7) {
        Py_ssize_t want = (t->size + n) * 2;
        if (want > t->max_entries * 2) want = t->max_entries * 2;
        if (want > t->capacity && keyregistry_grow(t, want) < 0) {
            PyBuffer_Release(&lo); PyBuffer_Release(&hi);
            PyBuffer_Release(&miss);
            return NULL;
        }
    }
    if (t->capacity) {
        const uint64_t *slo = (const uint64_t *)lo.buf;
        const uint64_t *shi = (const uint64_t *)hi.buf;
        uint8_t *smiss = (uint8_t *)miss.buf;
        uint64_t mask = (uint64_t)(t->capacity - 1);
        for (i = 0; i < n; i++) {
            uint64_t k = slo[i];
            Py_ssize_t j = (Py_ssize_t)(splitmix(k) & mask);
            while (t->used[j] && t->keys[j] != k) j = (j + 1) & mask;
            if (t->used[j]) {
                if (t->his[j] != shi[i]) {
                    conflict = i;
                    break;
                }
            } else if (!t->frozen) {
                t->used[j] = 1;
                t->keys[j] = k;
                t->his[j] = shi[i];
                t->size++;
                if (t->size >= t->max_entries) t->frozen = 1;
            } else {
                smiss[i] = 1;
            }
        }
    } else {
        /* zero-capacity table (cap so small nothing was ever inserted):
         * every key is an overflow miss once frozen; pre-freeze the grow
         * above always allocates, so capacity==0 implies nothing stored */
        uint8_t *smiss = (uint8_t *)miss.buf;
        if (t->frozen)
            for (i = 0; i < n; i++) smiss[i] = 1;
    }
    PyBuffer_Release(&lo);
    PyBuffer_Release(&hi);
    PyBuffer_Release(&miss);
    return PyLong_FromSsize_t(conflict);
}

static PyObject *keyregistry_stats(PyObject *self, PyObject *noarg) {
    KeyRegistryObject *t = (KeyRegistryObject *)self;
    (void)noarg;
    return Py_BuildValue("(ni)", t->size, t->frozen);
}

static void keyregistry_dealloc(PyObject *self) {
    KeyRegistryObject *t = (KeyRegistryObject *)self;
    free(t->keys); free(t->his); free(t->used);
    Py_TYPE(self)->tp_free(self);
}

static PyObject *keyregistry_new(PyTypeObject *type, PyObject *args,
                                 PyObject *kwds) {
    KeyRegistryObject *t;
    Py_ssize_t max_entries = 1 << 22;
    (void)kwds;
    if (!PyArg_ParseTuple(args, "|n", &max_entries)) return NULL;
    t = (KeyRegistryObject *)type->tp_alloc(type, 0);
    if (t == NULL) return NULL;
    t->keys = NULL; t->his = NULL; t->used = NULL;
    t->capacity = 0; t->size = 0; t->frozen = 0;
    t->max_entries = max_entries > 0 ? max_entries : 1;
    return (PyObject *)t;
}

static PyMethodDef keyregistry_methods[] = {
    {"register", keyregistry_register, METH_VARARGS,
     "register(lo_u64, hi_u64) -> first conflicting index or -1"},
    {"register_overflow", keyregistry_register_overflow, METH_VARARGS,
     "register_overflow(lo_u64, hi_u64, miss_u8) -> first conflicting "
     "index or -1; frozen-table misses flagged for the cold tier"},
    {"stats", keyregistry_stats, METH_NOARGS, "stats() -> (size, frozen)"},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject KeyRegistryType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_pathway_torch_native.KeyRegistry",
    .tp_basicsize = sizeof(KeyRegistryObject),
    .tp_dealloc = keyregistry_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "lo->hi key-lane registry for 128-bit conflation detection",
    .tp_methods = keyregistry_methods,
    .tp_new = keyregistry_new,
};

/* all_unique_u64(uint64_contiguous_buffer) -> bool
 *
 * O(n) open-addressing duplicate probe over already-avalanched engine
 * keys (splitmix64 outputs distribute uniformly, so the slot is just
 * the masked key). The consolidation identity fast path
 * (engine/delta.py) uses it to prove an all-insertions batch is
 * already consolidated — the alternative is the full row-signature
 * hash + sort. */
static PyObject *py_all_unique_u64(PyObject *self, PyObject *arg) {
    Py_buffer buf;
    if (PyObject_GetBuffer(arg, &buf, PyBUF_C_CONTIGUOUS) < 0) return NULL;
    if (buf.itemsize != 8) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_TypeError, "expected a uint64 buffer");
        return NULL;
    }
    Py_ssize_t n = buf.len / 8;
    const uint64_t *keys = (const uint64_t *)buf.buf;
    if (n < 2) {
        PyBuffer_Release(&buf);
        Py_RETURN_TRUE;
    }
    size_t cap = 64;
    while ((Py_ssize_t)cap < n * 2) cap <<= 1;
    uint64_t *table = (uint64_t *)calloc(cap, sizeof(uint64_t));
    if (table == NULL) {
        PyBuffer_Release(&buf);
        PyErr_NoMemory();
        return NULL;
    }
    size_t mask = cap - 1;
    int seen_zero = 0, unique = 1;
    for (Py_ssize_t i = 0; i < n; i++) {
        uint64_t k = keys[i];
        if (k == 0) { /* 0 marks empty slots: track it out-of-band */
            if (seen_zero) { unique = 0; break; }
            seen_zero = 1;
            continue;
        }
        size_t slot = (size_t)k & mask;
        for (;;) {
            uint64_t cur = table[slot];
            if (cur == 0) {
                table[slot] = k;
                break;
            }
            if (cur == k) {
                unique = 0;
                break;
            }
            slot = (slot + 1) & mask;
        }
        if (!unique) break;
    }
    free(table);
    PyBuffer_Release(&buf);
    if (unique) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

static PyMethodDef methods[] = {
    {"all_unique_u64", py_all_unique_u64, METH_O,
     "all_unique_u64(uint64_buffer) -> bool (O(n) duplicate probe)"},
    {"hash_rows", py_hash_rows, METH_VARARGS,
     "hash_rows(rows, salt, fallback, out_uint64_buffer)"},
    {"hash_scalars", py_hash_scalars, METH_VARARGS,
     "hash_scalars(values, fallback, out_uint64_buffer[, memo])"},
    {"hash_rows2", py_hash_rows2, METH_VARARGS,
     "hash_rows2(rows, salt_lo, salt_hi, fb_lo, fb_hi, memo, out_lo, out_hi)"},
    {"mix_cols2", py_mix_cols2, METH_VARARGS,
     "mix_cols2(cols, n, salt_lo, salt_hi, fb_lo, fb_hi, memo, out_lo, out_hi)"},
    {"hash_scalars2", py_hash_scalars2, METH_VARARGS,
     "hash_scalars2(values, fb_lo, fb_hi, memo, out_lo, out_hi)"},
    {"blake2b8", py_blake2b8, METH_O, "8-byte BLAKE2b digest as uint64"},
    {"blake2b16hi", py_blake2b16hi, METH_O,
     "second word of the 16-byte BLAKE2b digest (HI string lane)"},
    {"splitmix64", py_splitmix, METH_O, "splitmix64 finalizer"},
    {"splitmix64_2", py_splitmix2, METH_O, "HI-lane finalizer"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_pathway_torch_native",
    "Native keyspace kernels for pathway_tpu_torch", -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__pathway_torch_native(void) {
    PyObject *m;
    if (PyType_Ready(&KeyTableType) < 0) return NULL;
    m = PyModule_Create(&module);
    if (m == NULL) return NULL;
    Py_INCREF(&KeyTableType);
    if (PyModule_AddObject(m, "KeyTable", (PyObject *)&KeyTableType) < 0) {
        Py_DECREF(&KeyTableType);
        Py_DECREF(m);
        return NULL;
    }
    if (PyType_Ready(&KeyRegistryType) < 0) return NULL;
    Py_INCREF(&KeyRegistryType);
    if (PyModule_AddObject(m, "KeyRegistry", (PyObject *)&KeyRegistryType) < 0) {
        Py_DECREF(&KeyRegistryType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
