"""ctypes bridge to the native host kernels (native/ligero_host.cpp).

Compiled on demand with g++ into ``native/build/``; every entry point has
a pure-Python fallback, so the framework works without a toolchain (the
native path is ~100x faster for witness evaluation and sparse r^T·A at
2^20-gate scale).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

from .fields import FieldSpec

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "ligero_host.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_SRC), "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libligero_host.so")

_HASH_PATH = _LIB_PATH + ".srchash"

_lib = None
_tried = False


#: g++ command line for the host kernel lib (part of the cache key: a
#: flags-only change must rebuild, not silently serve a stale .so)
_HOST_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]


def _build_hash(src_path: str, flags: list[str]) -> str:
    import hashlib
    with open(src_path, "rb") as f:
        return hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()


def _src_hash() -> str:
    return _build_hash(_SRC, _HOST_FLAGS)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        # Reuse the cached .so only if it was built from exactly this
        # source (content hash recorded at build time) — a stale or
        # foreign binary must never be silently loaded into the prover.
        want = _src_hash()
        have = None
        if os.path.exists(_LIB_PATH) and os.path.exists(_HASH_PATH):
            with open(_HASH_PATH) as f:
                have = f.read().strip()
        if have != want:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            subprocess.run(
                ["g++", *_HOST_FLAGS, "-o", _LIB_PATH, _SRC],
                check=True, capture_output=True)
            with open(_HASH_PATH, "w") as f:
                f.write(want)
        lib = ctypes.CDLL(_LIB_PATH)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.lh_to_mont.argtypes = [ctypes.c_int, u64p, ctypes.c_uint64, u64p,
                                   u64p, ctypes.c_int64]
        lib.lh_from_mont.argtypes = lib.lh_to_mont.argtypes
        lib.lh_eval_circuit.restype = ctypes.c_int64
        lib.lh_eval_circuit.argtypes = [
            ctypes.c_int, u64p, ctypes.c_uint64, u64p,
            u8p, i64p, i64p, u64p, u8p, ctypes.c_int64]
        lib.lh_sparse_row_mul.argtypes = [
            ctypes.c_int, u64p, ctypes.c_uint64, u64p,
            ctypes.c_int64, i32p, i32p, u64p, u64p, u64p]
        lib.lh_sparse_row_mul_sorted.argtypes = \
            lib.lh_sparse_row_mul.argtypes
        lib.lh_poseidon_absorb.argtypes = [
            ctypes.c_int, u64p, ctypes.c_uint64, u64p,
            u64p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            u64p, i64p, i64p, u64p, ctypes.c_int64]
        lib.lh_chacha_fr_sample.argtypes = [
            ctypes.c_int, u64p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, u64p]
        lib.lh_mul_sum_rows.argtypes = [
            ctypes.c_int, u64p, ctypes.c_uint64, u64p,
            ctypes.c_int64, ctypes.c_int64, u64p, u64p, u64p]
        lib.lh_quad_spot.argtypes = [
            ctypes.c_int, u64p, ctypes.c_uint64, u64p,
            ctypes.c_int64, ctypes.c_int64, u64p, u64p, u64p, u64p, u64p]
        _lib = lib
    except Exception as e:  # noqa: BLE001
        sys.stderr.write(f"ligero_jax: native kernels unavailable ({e}); "
                         "falling back to Python\n")
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# PyLong batch converters (native/ligero_pylong.c, loaded via PyDLL)
# ---------------------------------------------------------------------------

_PYSRC = os.path.join(os.path.dirname(_SRC), "ligero_pylong.c")
_PYLIB_PATH = os.path.join(_BUILD_DIR, "libligero_pylong.so")
_PYHASH_PATH = _PYLIB_PATH + ".srchash"

_pylib = None
_pytried = False


def _pyload():
    """Compile/load the PyLong converter lib (PyDLL: GIL held per call)."""
    global _pylib, _pytried
    if _pytried:
        return _pylib
    _pytried = True
    try:
        import sysconfig
        pyflags = ["-O3", "-shared", "-fPIC",
                   "-I" + sysconfig.get_paths()["include"]]
        want = _build_hash(_PYSRC, pyflags)
        have = None
        if os.path.exists(_PYLIB_PATH) and os.path.exists(_PYHASH_PATH):
            with open(_PYHASH_PATH) as f:
                have = f.read().strip()
        if have != want:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            subprocess.run(
                ["g++", *pyflags, "-o", _PYLIB_PATH, _PYSRC],
                check=True, capture_output=True)
            with open(_PYHASH_PATH, "w") as f:
                f.write(want)
        lib = ctypes.PyDLL(_PYLIB_PATH)
        lib.lp_longs_from_le.restype = ctypes.py_object
        lib.lp_longs_from_le.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t,
                                         ctypes.c_ssize_t]
        lib.lp_le_from_longs.restype = ctypes.c_int
        lib.lp_le_from_longs.argtypes = [ctypes.py_object, ctypes.c_ssize_t,
                                         ctypes.c_void_p]
        # smoke-test: the private _PyLong_* ABI must behave on this
        # interpreter before the fast path is trusted
        probe = lib.lp_longs_from_le(b"\x02\x01" b"\xff\x00", 2, 2)
        buf = ctypes.create_string_buffer(4)
        rc = lib.lp_le_from_longs([258, 255], 2, buf)
        if probe != [258, 255] or rc != 0 or buf.raw != b"\x02\x01\xff\x00":
            raise RuntimeError("pylong converter self-test failed")
        _pylib = lib
    except Exception as e:  # noqa: BLE001
        sys.stderr.write(f"ligero_jax: pylong converters unavailable ({e}); "
                         "falling back to Python int loops\n")
        _pylib = None
    return _pylib


def pylong_available() -> bool:
    return _pyload() is not None


def longs_from_le_bytes(buf, n: int, width: int) -> list[int]:
    """n little-endian unsigned width-byte elements -> list[int].

    ``buf``: bytes or a C-contiguous numpy array with n*width total bytes.
    """
    lib = _pyload()
    if isinstance(buf, np.ndarray):
        assert buf.flags["C_CONTIGUOUS"] and buf.nbytes == n * width
        addr = buf.ctypes.data
        out = lib.lp_longs_from_le(addr, n, width)
        # keep buf alive across the call (addr borrowed)
        del buf
        return out
    assert len(buf) == n * width
    return lib.lp_longs_from_le(buf, n, width)


def le_bytes_from_longs(values, width: int) -> bytes:
    """Sequence of non-negative ints -> concatenated width-byte LE bytes
    (int.to_bytes semantics: OverflowError when a value does not fit)."""
    lib = _pyload()
    out = ctypes.create_string_buffer(len(values) * width)
    rc = lib.lp_le_from_longs(values, width, out)
    if rc != 0:  # pragma: no cover — ctypes raised already via exception
        raise RuntimeError("le_bytes_from_longs failed")
    return out.raw


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _field_args(field: FieldSpec):
    nl = field.num_u64_limbs
    p = np.array([(field.p >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(nl)],
                 dtype=np.uint64)
    n0inv = (-pow(field.p, -1, 1 << 64)) % (1 << 64)
    r2 = np.array([(field.R2 >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(nl)],
                  dtype=np.uint64)
    return nl, p, np.uint64(n0inv), r2


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def u64_to_u16_view(a: np.ndarray, num_limbs16: int) -> np.ndarray:
    """(N, NL) uint64 -> (N, L) uint16 view of the SAME buffer (zero copy).

    LSB-first u64 limbs viewed as little-endian u16 are exactly the
    16-bit limb order.  uint16 is a valid host limb-array dtype: jax
    consumers widen on-device at the jit boundary (Backend._jit16),
    which also halves the host->device transfer; numpy FieldKernel
    consumers must widen explicitly (uint16*uint16 would overflow)."""
    n = a.shape[0]
    return np.ascontiguousarray(a).view("<u2").reshape(n, num_limbs16)


def u64_to_u16_limbs(a: np.ndarray, num_limbs16: int) -> np.ndarray:
    """(N, NL) uint64 -> (N, L) uint32 16-bit limbs (same integers).

    LSB-first u64 limbs viewed as little-endian u16 are exactly the
    16-bit limb order — one widening copy, no strided passes."""
    n = a.shape[0]
    return (np.ascontiguousarray(a).view("<u2")
            .reshape(n, num_limbs16).astype(np.uint32))


def u16_to_u64_limbs(a: np.ndarray) -> np.ndarray:
    """(N, L) uint32 16-bit limbs -> (N, L/4) uint64 (inverse view)."""
    a16 = np.ascontiguousarray(a.astype(np.uint16))
    return a16.view("<u8").reshape(a.shape[0], a.shape[1] // 4)


def ints_to_u64_limbs(values: list[int], nl: int) -> np.ndarray:
    nbytes = nl * 8
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    return np.frombuffer(buf, dtype="<u8").reshape(len(values), nl).copy()


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def to_mont_inplace(field: FieldSpec, values_u64: np.ndarray) -> None:
    lib = _load()
    nl, p, n0inv, r2 = _field_args(field)
    lib.lh_to_mont(nl, _ptr(p, ctypes.c_uint64), n0inv,
                   _ptr(r2, ctypes.c_uint64),
                   _ptr(values_u64, ctypes.c_uint64), values_u64.shape[0])


def from_mont_inplace(field: FieldSpec, values_u64: np.ndarray) -> None:
    lib = _load()
    nl, p, n0inv, r2 = _field_args(field)
    lib.lh_from_mont(nl, _ptr(p, ctypes.c_uint64), n0inv,
                     _ptr(r2, ctypes.c_uint64),
                     _ptr(values_u64, ctypes.c_uint64), values_u64.shape[0])


def eval_circuit_mont(field: FieldSpec, kinds: np.ndarray, lefts: np.ndarray,
                      rights: np.ndarray, values_u64: np.ndarray,
                      have: np.ndarray) -> None:
    """Forward-evaluate a topological circuit; values in/out Montgomery."""
    lib = _load()
    nl, p, n0inv, r2 = _field_args(field)
    rc = lib.lh_eval_circuit(
        nl, _ptr(p, ctypes.c_uint64), n0inv, _ptr(r2, ctypes.c_uint64),
        _ptr(kinds, ctypes.c_uint8), _ptr(lefts, ctypes.c_int64),
        _ptr(rights, ctypes.c_int64), _ptr(values_u64, ctypes.c_uint64),
        _ptr(have, ctypes.c_uint8), kinds.shape[0])
    if rc != 0:
        raise ValueError(f"Uninitialised node at index {rc - 1}")


def sparse_row_mul_mont(field: FieldSpec, rows: np.ndarray, cols: np.ndarray,
                        vals_mont_u64: np.ndarray, r_mont_u64: np.ndarray,
                        num_cols: int, col_sorted: bool = False) -> np.ndarray:
    """``out = r^T A`` over COO entries.  With ``col_sorted=True`` the
    entries MUST be stably sorted by column — the kernel then partitions
    columns across OpenMP threads (bit-identical sums: per-column entry
    order is preserved by the stable sort and each column is owned by
    exactly one thread)."""
    lib = _load()
    nl, p, n0inv, r2 = _field_args(field)
    out = np.zeros((num_cols, nl), dtype=np.uint64)
    fn = lib.lh_sparse_row_mul_sorted if col_sorted else lib.lh_sparse_row_mul
    fn(nl, _ptr(p, ctypes.c_uint64), n0inv, _ptr(r2, ctypes.c_uint64),
       rows.shape[0], _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
       _ptr(vals_mont_u64, ctypes.c_uint64), _ptr(r_mont_u64, ctypes.c_uint64),
       _ptr(out, ctypes.c_uint64))
    return out


def mul_sum_rows_mont(field: FieldSpec, a_u64: np.ndarray,
                      b_u64: np.ndarray) -> np.ndarray:
    """``out[j] = sum_i a[i,j]*b[i,j]*R^-1 mod p`` — the verifier's
    per-opened-column inner products, one C pass over (rows, cols, nl)
    u64-limb operands."""
    lib = _load()
    nl, p, n0inv, r2 = _field_args(field)
    rows, cols = a_u64.shape[0], a_u64.shape[1]
    assert a_u64.shape == b_u64.shape == (rows, cols, nl)
    out = np.zeros((cols, nl), dtype=np.uint64)
    lib.lh_mul_sum_rows(nl, _ptr(p, ctypes.c_uint64), n0inv,
                        _ptr(r2, ctypes.c_uint64), rows, cols,
                        _ptr(np.ascontiguousarray(a_u64), ctypes.c_uint64),
                        _ptr(np.ascontiguousarray(b_u64), ctypes.c_uint64),
                        _ptr(out, ctypes.c_uint64))
    return out


def quad_spot_mont(field: FieldSpec, x_u64, y_u64, z_u64,
                   r_u64) -> np.ndarray:
    """``out[j] = sum_i r[i]*(x[i,j]*y[i,j] - z[i,j])`` mod p — the
    verifier's quadratic per-column test (x,y,z canonical, r Montgomery)."""
    lib = _load()
    nl, p, n0inv, r2 = _field_args(field)
    rows, cols = x_u64.shape[0], x_u64.shape[1]
    out = np.zeros((cols, nl), dtype=np.uint64)
    lib.lh_quad_spot(nl, _ptr(p, ctypes.c_uint64), n0inv,
                     _ptr(r2, ctypes.c_uint64), rows, cols,
                     _ptr(np.ascontiguousarray(x_u64), ctypes.c_uint64),
                     _ptr(np.ascontiguousarray(y_u64), ctypes.c_uint64),
                     _ptr(np.ascontiguousarray(z_u64), ctypes.c_uint64),
                     _ptr(np.ascontiguousarray(r_u64), ctypes.c_uint64),
                     _ptr(out, ctypes.c_uint64))
    return out


_sample_bufs = __import__("threading").local()


def tune_malloc(mmap_threshold: int = 1 << 31) -> bool:
    """Route big allocations through the (reused, stays-faulted) brk heap.

    First-touch page faults on this host cost ~130 µs/4 KB page, so every
    fresh gigabyte-scale allocation (challenge vectors, opened-column
    downloads — reallocated per proof) pays tens of seconds before any
    work happens.  glibc serves allocations above M_MMAP_THRESHOLD from
    fresh mmaps (faulted every time); raising it and disabling trim keeps
    the pages resident across alloc/free cycles.  Costs RSS (freed blocks
    stay mapped).  Called at import when ``LIGERO_MALLOC_TUNE=1``."""
    try:
        libc = ctypes.CDLL(None)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        ok1 = libc.mallopt(M_MMAP_THRESHOLD,
                           ctypes.c_int(min(mmap_threshold, 2**31 - 1)))
        ok2 = libc.mallopt(M_TRIM_THRESHOLD, ctypes.c_int(2**31 - 1))
        return bool(ok1 and ok2)
    except Exception:  # noqa: BLE001 — purely advisory
        return False


def chacha_fr_sample(field: FieldSpec, count: int, seed: bytes,
                     reuse: bool = False) -> np.ndarray:
    """``count`` accepted ``F::rand`` draws off a fresh ChaCha20(seed)
    stream, as ``(count, nl)`` raw-u64 limbs (= the Montgomery form; ark
    semantics).  Bit-identical to the numpy sampler in
    ``sampling.rand_field_elements_limbs`` — cross-checked in tests.

    ``reuse=True`` writes into a per-(count, nl, thread) cached buffer
    instead of a fresh allocation — callers must consume the result
    before their next same-shape reuse=True call (the phase-local
    challenge expansions do).  Why: the challenge vector is regenerated
    at an identical shape every proof, and first-touch page faults on a
    fresh ~1 GB allocation dominate the sampler itself on this host
    (~30s of faulting vs ~4s of generation at 2^22).
    ``LIGERO_SAMPLER_BUF_CACHE=0`` disables the reuse globally."""
    lib = _load()
    nl, p, n0inv, r2 = _field_args(field)
    shave = 64 * nl - field.modulus_bit_size
    topmask = (0xFFFFFFFFFFFFFFFF >> shave) if shave < 64 else 0
    key = np.frombuffer(seed, dtype=np.uint32)
    if reuse and os.environ.get("LIGERO_SAMPLER_BUF_CACHE") != "0":
        cache = getattr(_sample_bufs, "bufs", None)
        if cache is None:
            cache = _sample_bufs.bufs = {}
        out = cache.get((count, nl))
        if out is None:
            out = cache[(count, nl)] = np.empty((count, nl), dtype=np.uint64)
    else:
        out = np.empty((count, nl), dtype=np.uint64)
    lib.lh_chacha_fr_sample(
        nl, _ptr(p, ctypes.c_uint64), np.uint64(topmask),
        _ptr(key, ctypes.c_uint32), count, _ptr(out, ctypes.c_uint64))
    return out


def poseidon_absorb(field: FieldSpec, ark_mont_u64: np.ndarray,
                    full_rounds: int, partial_rounds: int, alpha: int,
                    state_mont_u64: np.ndarray, mode: int, mode_index: int,
                    elems_mont_u64: np.ndarray) -> tuple[int, int]:
    """Run the ark duplex-sponge absorb state machine natively.

    ``state_mont_u64`` (3, nl) is updated in place; returns the new
    (mode, mode_index).  All field values Montgomery (see
    native/ligero_host.cpp lh_poseidon_absorb)."""
    lib = _load()
    nl, p, n0inv, r2 = _field_args(field)
    mode_arr = np.array([mode], dtype=np.int64)
    idx_arr = np.array([mode_index], dtype=np.int64)
    lib.lh_poseidon_absorb(
        nl, _ptr(p, ctypes.c_uint64), n0inv, _ptr(r2, ctypes.c_uint64),
        _ptr(ark_mont_u64, ctypes.c_uint64), full_rounds, partial_rounds,
        np.uint64(alpha), _ptr(state_mont_u64, ctypes.c_uint64),
        _ptr(mode_arr, ctypes.c_int64), _ptr(idx_arr, ctypes.c_int64),
        _ptr(elems_mont_u64, ctypes.c_uint64), elems_mont_u64.shape[0])
    return int(mode_arr[0]), int(idx_arr[0])
