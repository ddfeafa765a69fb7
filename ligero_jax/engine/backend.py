"""Execution backend facade: bulk protocol math over limb arrays.

One ``Backend`` instance binds a field to an array namespace:

* ``Backend(field)`` — numpy host execution (bit-exact golden path);
* ``Backend(field, use_jax=True)`` — jit-compiled execution on JAX's
  default device.  Each distinct operation/shape compiles once and is
  cached.

Routes are chosen from the device's platform and the transform size,
never by an option: on a GPU the NTTs take the int8 four-step route
(mxu_ntt.py), the challenge combination the int8 contraction (mxu_lc.py)
and the column hash the Triton kernel (pallas_hash.py); on the CPU the
scan-form XLA kernels (FieldKernel, DomainOps, HashKernel) run.

The protocol layer (ligero_jax.ligero) only ever touches these methods;
everything below them is the generic limb kernel code in fieldops/ntt.
"""

from __future__ import annotations

import numpy as np

from ..fields import FieldSpec
from .devmatrix import RowChunkedMatrix, StreamedCodewords
from .fieldops import FieldKernel
from .hashops import HashKernel, be_words_to_bytes, words_to_le_bytes
from .mxu_lc import mxu_lc, mxu_lc_ok
from .mxu_ntt import mxu_any_ok, ntt_fourstep_any
from .mxu_spot import mxu_spot_ok
from .ntt import DomainOps
from .pallas_hash import TILE, blake2s_columns


def _zero_extend(xp, x, n: int):
    """Zero-extend axis -2 of ``x`` to length n."""
    w = x.shape[-2]
    if w == n:
        return x
    return xp.concatenate(
        [x, xp.zeros(x.shape[:-2] + (n - w, x.shape[-1]), np.uint32)],
        axis=-2)


_BACKENDS: dict = {}


def get_backend(field: FieldSpec, use_jax: bool = False) -> "Backend":
    """Shared Backend per (field, engine) — keeps jit caches warm across
    LigeroCircuit instances."""
    key = (field.name, use_jax)
    if key not in _BACKENDS:
        _BACKENDS[key] = Backend(field, use_jax)
    return _BACKENDS[key]


def device_platform() -> str:
    """Platform of JAX's default device ("cpu" or "gpu")."""
    import jax
    platform = jax.devices()[0].platform
    if platform not in ("cpu", "gpu"):
        raise RuntimeError(f"no route for platform {platform!r}")
    return platform


class Backend:
    def __init__(self, field: FieldSpec, use_jax: bool = False):
        self.field = field
        self.use_jax = use_jax
        # where the bulk ops run: "numpy" on the host, else the platform
        # of JAX's default device, which picks the routes below
        self.platform = device_platform() if use_jax else "numpy"
        self.on_gpu = self.platform == "gpu"
        if use_jax:
            import jax
            import jax.numpy as jnp
            self._jax = jax
            self.xp = jnp
        else:
            self.xp = np
        # limb recurrences in scan form on every platform: XLA's CPU
        # compiler chokes on the unrolled graphs, and on the GPU the
        # unrolled mont_mul, 3x faster per call, compiles 27x longer
        # (PERF.md; whether it pays off end to end is open, ROADMAP 3.2)
        self.fk = FieldKernel(field, self.xp)
        self.hk = HashKernel(self.xp)
        self._domains: dict[int, DomainOps] = {}
        self._jit_cache: dict = {}
        # resident_ok: may the protocol keep device-resident chunked state
        # at all (RowChunkedMatrix / StreamedCodewords / mesh-resident).
        # resident_u_ok: may it pin the FULL codeword matrix U resident
        # (single-device yes; ShardedBackend overrides to False so
        # beyond-one-buffer encodes go straight to the mesh-streaming
        # commit instead of an unsharded single-device resident U).
        self.resident_ok = use_jax
        self.resident_u_ok = True

    # ------------------------------------------------------------------
    def domain(self, n: int) -> DomainOps:
        if n not in self._domains:
            self._domains[n] = DomainOps(self.fk, n)
        return self._domains[n]

    def _jit(self, key, fn):
        if not self.use_jax:
            return fn
        if key not in self._jit_cache:
            self._jit_cache[key] = self._jax.jit(fn)
        return self._jit_cache[key]

    def _jit16(self, key, fn):
        """Like :meth:`_jit`, but numpy uint32 *limb* arguments ship to the
        device as uint16 and widen on-device — valid because every limb
        array holds 16-bit limbs by representation invariant; it halves
        the bytes each host->device upload moves.  Device-resident
        arguments pass through untouched."""
        if not self.use_jax:
            return fn
        wkey = key + ("u16",)
        if wkey not in self._jit_cache:
            def widen(*xs):
                return fn(*[x.astype(np.uint32) if x.dtype == np.uint16 else x
                            for x in xs])
            self._jit_cache[wkey] = self._jax.jit(widen)
        jfn = self._jit_cache[wkey]

        def call(*args):
            return jfn(*[a.astype(np.uint16)
                         if isinstance(a, np.ndarray) and a.dtype == np.uint32
                         else a for a in args])
        return call

    def asarray(self, a: np.ndarray):
        return self.xp.asarray(a)

    def to_numpy(self, a) -> np.ndarray:
        return np.asarray(a)

    # ------------------------------------------------------------------
    # protocol building blocks
    # ------------------------------------------------------------------
    def _fourstep(self, n: int) -> bool:
        """Route transforms of size n through the int8 four-step NTT: on
        the GPU, for every n it covers (16-limb fields, 1024 <= n <=
        65536); DomainOps' radix-2 stages everywhere else."""
        return self.on_gpu and mxu_any_ok(n, self.field)

    def _fourstep_ntt(self, x, n: int, inverse: bool = False,
                      canon_out: bool = False):
        lead = x.shape[:-2]
        y = ntt_fourstep_any(self.fk, x.reshape((-1,) + x.shape[-2:]), n,
                             inverse=inverse, canon_out=canon_out)
        return y.reshape(lead + y.shape[-2:])

    def _fft_padded(self, coeffs, n: int):
        """fft with zero-extension to n."""
        if self._fourstep(n):
            return self._fourstep_ntt(_zero_extend(self.xp, coeffs, n), n)
        return self.domain(n).fft_padded(coeffs)

    def _ifft(self, evals, n: int):
        if self._fourstep(n):
            return self._fourstep_ntt(evals, n, inverse=True)
        return self.domain(n).ifft(evals)

    def _fft_canon(self, coeffs, n: int):
        """fft with zero-extension, emitting canonical limbs: the
        four-step route folds R^-1 into its stage-2 twiddle (no separate
        from-Montgomery pass over the n-wide matrix)."""
        if self._fourstep(n):
            return self._fourstep_ntt(_zero_extend(self.xp, coeffs, n), n,
                                      canon_out=True)
        return self._from_mont_chunked(self.domain(n).fft_padded(coeffs))

    def rs_encode_rows(self, preenc, k: int, n: int):
        """(B, k, L) message rows -> (coeffs (B,k,L), evals (B,n,L)).

        Equivalent to the reference's per-row ifft_k + fft_n
        (/root/reference/src/ligero/mod.rs:998-1012), batched.
        """

        def run(x):
            coeffs = self._ifft(x, k)
            evals = self._fft_padded(coeffs, n)
            return coeffs, evals

        return self._jit16(("rs", k, n, preenc.shape), run)(preenc)

    def ntt(self, coeffs, n: int):
        return self._jit16(("fft", n, coeffs.shape),
                           lambda x: self._fft_padded(x, n))(coeffs)

    def _concat_rows_dev(self, parts):
        """Concatenate same-shape per-chunk device results along axis 0
        in ONE dispatch and return the device array, so the host makes
        one transfer instead of one per chunk."""
        if len(parts) == 1:
            return parts[0]
        fn = self._jit(("concat_rows", len(parts), tuple(parts[0].shape),
                        tuple(parts[-1].shape)),
                       lambda *xs: self.xp.concatenate(xs, axis=0))
        return fn(*parts)

    def _use_mxu_spot(self, n: int, t: int) -> bool:
        """Direct evaluation at the t opened columns instead of full
        n-point NTTs (mxu_spot.py): a dense (rows, k) x (k, t) int8 limb
        contraction in place of rows x n-point transforms."""
        return (self.use_jax and 0 < t <= 4096
                and mxu_spot_ok(self.field, n))

    def _spot_weights_dev(self, k: int, n: int, jdev):
        from .mxu_spot import spot_weights
        return self._jit(("spot_w", k, int(jdev.shape[0]), n),
                         lambda j: spot_weights(self.xp, self.field,
                                                j, k, n))(jdev)

    def _spot_block16(self, blk, w7, n: int, canon: bool):
        """One row block's spot evaluations, as uint16 for the download."""
        from .mxu_spot import mxu_spot_eval
        fn = self._jit(
            ("spot_cols", tuple(blk.shape), tuple(w7.shape), n, canon),
            lambda c, w: mxu_spot_eval(self.xp, self.field, c, w,
                                       canon_out=canon).astype(np.uint16))
        return fn(blk, w7)

    def ntt_columns(self, coeffs, n: int, js: np.ndarray) -> np.ndarray:
        """Evaluate all B rows' n-point NTTs but return only columns ``js``:
        (B, k, L) -> (B, len(js), L) numpy.

        The verifier's spot checks need the 4m r_i codewords only at the t
        opened columns (reference mod.rs:815-829 computes all n per row);
        gathering on-device keeps the full (B, n, L) matrix out of both
        HBM-resident memory (row chunks respect the buffer budget) and the
        host transfer.  When the spot evaluation is admissible it replaces
        the per-row NTTs entirely (bit-identical output — tested).
        """
        js = np.ascontiguousarray(np.asarray(js, dtype=np.int32))
        if self._use_mxu_spot(n, len(js)):
            jdev = self.asarray(js)
            if isinstance(coeffs, RowChunkedMatrix):
                w7 = self._spot_weights_dev(coeffs.n, n, jdev)
                parts = [self._spot_block16(c, w7, n, False)
                         for c in coeffs.chunks]
                out = self.to_numpy(self._concat_rows_dev(parts))
                return out[:coeffs.rows].astype(np.uint32)
            B, k, L = coeffs.shape
            w7 = self._spot_weights_dev(k, n, jdev)
            # row chunks bound the per-dispatch limb-plane transients
            chunk = max(8, self.MAX_DEVICE_BYTES // (n * L * 4))
            parts = []
            for i in range(0, B, chunk):
                blk = coeffs[i:i + chunk]
                rows = blk.shape[0]
                xp0 = np if isinstance(blk, np.ndarray) else self.xp
                if rows < chunk and B > chunk:
                    blk = xp0.concatenate(
                        [blk, xp0.zeros((chunk - rows,) + tuple(blk.shape[1:]),
                                        blk.dtype)])
                parts.append(self._spot_block16(self.asarray(blk), w7, n,
                                                False))
            out = self.to_numpy(self._concat_rows_dev(parts))
            return out[:B].astype(np.uint32)
        if isinstance(coeffs, RowChunkedMatrix):
            jdev = self.asarray(js)

            def run_rcm(x, j):
                ev = self._fft_padded(x, n)
                return self.xp.take(ev, j, axis=1).astype(np.uint16)

            parts = [self._jit16(
                ("fft_cols_rcm", n, c.shape, len(js)), run_rcm)(c, jdev)
                for c in coeffs.chunks]
            out = self.to_numpy(self._concat_rows_dev(parts))
            return out[:coeffs.rows].astype(np.uint32)
        B, _, L = coeffs.shape
        jdev = self.asarray(js)

        # indices are a traced argument, NOT a baked constant: the opened
        # columns change every proof, and a js-keyed jit would compile
        # afresh per verification
        def run(x, j):
            ev = self._fft_padded(x, n)
            # u16 download: limbs < 2^16 (halves the (B, t, L) transfer)
            return self.xp.take(ev, j, axis=1).astype(np.uint16)

        if self.use_jax and B * n * L * 4 > self.MAX_DEVICE_BYTES:
            chunk = max(8, self.MAX_DEVICE_BYTES // (n * L * 4))
            out = np.empty((B, len(js), L), np.uint32)
            for i in range(0, B, chunk):
                # slice in place (device arrays stay on device)
                blk = coeffs[i:i + chunk]
                rows = blk.shape[0]
                xp0 = np if isinstance(blk, np.ndarray) else self.xp
                if rows < chunk:
                    blk = xp0.concatenate(
                        [blk, xp0.zeros((chunk - rows,) + tuple(blk.shape[1:]),
                                        np.uint32)])
                res = self._jit(("fft_cols", n, tuple(blk.shape), len(js)), run)(
                    self.asarray(blk), jdev)
                out[i:i + rows] = self.to_numpy(res)[:rows]
            return out
        return self.to_numpy(
            self._jit(("fft_cols", n, coeffs.shape, len(js)), run)(
                self.asarray(coeffs), jdev)).astype(np.uint32)

    def ntt_columns_batch(self, coeffs_b: np.ndarray, n: int,
                          idx: np.ndarray) -> np.ndarray:
        """Per-proof spot-column encodes: coeffs (B, rows, w, L) + idx
        (B, t) -> (B, rows, t, L) numpy.

        One fused device dispatch over all B proofs' ``rows`` n-point
        NTTs, each proof keeping only its own opened columns — the
        batched form of :meth:`ntt_columns` for ``verify_batch`` (the
        per-proof values are identical; tested).  Indices are a traced
        argument (they change every proof; a baked constant would force
        a fresh compile per verification batch).
        """
        coeffs_b = np.ascontiguousarray(coeffs_b)
        B, rows, w, L = coeffs_b.shape
        idx = np.ascontiguousarray(np.asarray(idx, dtype=np.int32))
        if self._use_mxu_spot(n, idx.shape[1]):
            # per-proof spot evaluation (bit-identical; the batched
            # NTT's win was amortizing the full-encode — the spot kernel
            # removes that cost instead)
            return np.stack([self.ntt_columns(coeffs_b[i], n, idx[i])
                             for i in range(B)], axis=0)
        per_proof = rows * n * L * 4
        sub = max(1, self.MAX_DEVICE_BYTES // per_proof)
        if self.use_jax and sub < B:
            out = np.empty((B, rows, idx.shape[1], L), np.uint32)
            for i in range(0, B, sub):
                out[i:i + sub] = self.ntt_columns_batch(
                    coeffs_b[i:i + sub], n, idx[i:i + sub])
            return out
        xp = self.xp

        def run(x, j):
            ev = self._fft_padded(x.reshape(B * rows, w, L), n)
            ev = ev.reshape(B, rows, n, L)
            return xp.take_along_axis(
                ev, j[:, None, :, None], axis=2).astype(np.uint16)

        res = self._jit(("fft_cols_b", n, coeffs_b.shape, idx.shape), run)(
            self.asarray(coeffs_b), self.asarray(idx))
        return self.to_numpy(res).astype(np.uint32)

    def intt(self, evals, n: int):
        return self._jit16(("ifft", n, evals.shape),
                           lambda x: self._ifft(x, n))(evals)

    def _from_mont_chunked(self, a):
        """Montgomery->canonical with the row axis chunked via lax.map.

        Above the threshold the rows go through lax.map chunks (zero-row
        padded when the row count doesn't divide), which bounds the scan
        carry state at ~0.5 GB."""
        if not self.use_jax or a.ndim != 3:
            return self.fk.from_mont(a)
        rows, n, L = a.shape
        chunk = max(1, (1 << 26) // (n * 2 * L * 4))  # ~0.5 GB carries
        if rows <= chunk:
            return self.fk.from_mont(a)
        xp = self.xp
        pad = (-rows) % chunk
        if pad:
            a = xp.concatenate(
                [a, xp.zeros((pad, n, L), np.uint32)], axis=0)
        out = self._jax.lax.map(
            self.fk.from_mont,
            a.reshape((rows + pad) // chunk, chunk, n, L))
        out = out.reshape(rows + pad, n, L)
        return out[:rows] if pad else out

    def from_mont(self, a):
        return self._jit(("from_mont", a.shape),
                         self._from_mont_chunked)(self.asarray(a))

    def rs_encode_and_canon(self, preenc, k: int, n: int):
        """Fused encode + Montgomery->canonical: (B,k,L) -> (coeffs, canon).

        The Montgomery-form codeword matrix dies inside the jitted call, so
        peak HBM is one n-wide matrix lower than calling rs_encode_rows and
        from_mont separately — the difference between fitting and OOM at
        the 2^20-gate scale.
        """

        def run(x):
            coeffs = self._ifft(x, k)
            return coeffs, self._fft_canon(coeffs, n)

        return self._jit16(("rs_canon", k, n, preenc.shape), run)(preenc)

    def ntt_and_canon(self, coeffs, n: int):
        """Fused coefficient-space encode + Montgomery->canonical:
        (B, w, L) coefficient rows (w <= n, zero-extended) -> (B, n, L)
        canonical codewords.  The zk prover's commit path: blinded rows are
        already in coefficient space, so the iNTT half of
        :meth:`rs_encode_and_canon` is skipped."""

        def run(x):
            return self._fft_canon(x, n)

        return self._jit16(("ntt_canon", n, coeffs.shape), run)(coeffs)

    # ------------------------------------------------------------------
    # device-resident (RowChunkedMatrix) paths — see devmatrix.py
    # ------------------------------------------------------------------
    def rs_encode_resident(self, preenc, k: int, n: int):
        """RS-encode all rows into device-resident chunked matrices.

        Returns ``(coeffs: RowChunkedMatrix (rows,k,L),
        canon: RowChunkedMatrix (rows,n,L))``.  Only the (small) message
        chunks are uploaded; nothing is downloaded — the codeword matrix
        stays on the device for commit / column opening / poly products.
        """
        rows, k_, L = preenc.shape
        chunk = max(8, self.MAX_DEVICE_BYTES // (n * L * 4))
        on_device = not isinstance(preenc, np.ndarray)
        xp0 = self.xp if on_device else np
        coeff_chunks, canon_chunks = [], []
        for i in range(0, rows, chunk):
            blk = preenc[i:i + chunk]  # device slice stays on device
            r = blk.shape[0]
            if r < chunk:
                blk = xp0.concatenate(
                    [blk, xp0.zeros((chunk - r, k_, L), blk.dtype)])
            c, u = self.rs_encode_and_canon(blk, k, n)
            coeff_chunks.append(self.narrow16(c))
            canon_chunks.append(self.narrow16(u))
        return (RowChunkedMatrix(coeff_chunks, rows, chunk),
                RowChunkedMatrix(canon_chunks, rows, chunk))

    def intt_resident(self, preenc: np.ndarray, k: int,
                      n: int | None = None) -> RowChunkedMatrix:
        """iNTT_k of all rows into a device-resident chunked coefficient
        matrix, uploading the (host) message matrix in u16 chunks.

        The entry point of the streaming-commit path: only the 8x-smaller
        coefficient form ever lives in HBM; codeword chunks are re-derived
        on demand (see :class:`StreamedCodewords`).  ``n``: the codeword
        width consumers re-expand to (chunk sizing; 16k assumed absent)."""
        rows, k_, L = preenc.shape
        # chunk sized by the CODEWORD width n = rate_inv * k the consumers
        # re-expand to — keep it aligned with _stream_chunk_rows
        chunks = []
        chunk = self._stream_chunk_rows(self.field, k, n)
        for i in range(0, rows, chunk):
            blk = np.ascontiguousarray(preenc[i:i + chunk])
            r = blk.shape[0]
            if r < chunk:
                blk = np.concatenate(
                    [blk, np.zeros((chunk - r, k_, L), blk.dtype)])
            chunks.append(self.narrow16(self.intt(blk, k)))
        return RowChunkedMatrix(chunks, rows, chunk)

    def _stream_chunk_rows(self, field, k: int,
                           n: int | None = None) -> int:
        """Row-chunk size for the streaming paths: the re-expanded
        (chunk, n, L) codeword block must stay under the single-buffer
        budget for the largest n any consumer uses.  Callers that know
        the circuit's actual codeword width pass ``n`` (every shipped
        config has n = 8k, which doubles the chunk vs the conservative
        16k assumption — at 2^22 that is 65 serialized NTT+absorb
        dispatch pairs instead of 129); absent, assume 16k and clamp.
        Forced even so each chunk contributes a whole number of 64-byte
        blocks per column to the streaming hash."""
        n_max = max(n or 16 * k, 2 * k)
        chunk = max(8, self.MAX_DEVICE_BYTES // (n_max * field.num_limbs * 4))
        return chunk & ~1

    def coeffs_resident(self, rows_coeffs: np.ndarray,
                        n: int) -> RowChunkedMatrix:
        """Upload already-computed coefficient rows (any width w <= n) as
        u16 device-resident chunks sized for re-expansion to ``n``-point
        codewords — the zk prover's entry into the streaming commit (its
        rows are blinded to width k+3t, so they arrive as coefficients
        rather than through :meth:`intt_resident`)."""
        rows, w, L = rows_coeffs.shape
        chunk = max(8, self.MAX_DEVICE_BYTES // (n * self.field.num_limbs * 4))
        chunk &= ~1
        chunk = max(chunk, 2)
        src, xpu = self._rows_source(rows_coeffs)
        chunks = []
        for i in range(0, rows, chunk):
            blk = src[i:i + chunk]
            r = blk.shape[0]
            if r < chunk:
                blk = xpu.concatenate(
                    [blk, xpu.zeros((chunk - r, w, L), blk.dtype)])
            if xpu is np:
                chunks.append(self.asarray(
                    np.ascontiguousarray(blk).astype(np.uint16, copy=False)))
            else:
                chunks.append(self.narrow16(blk))
        return RowChunkedMatrix(chunks, rows, chunk)

    def _encode_block_canon(self, coeff_blk, k: int, n: int):
        """(rows, w<=n, L) Montgomery coefficient block -> (rows, n, L)
        canonical codewords: the ONE re-encode program both streaming
        consumers (commit absorb + opening gather) share."""
        return self._fft_canon(self._widen(coeff_blk), n)

    def _stream_encode(self, chunk, k: int, n: int):
        """Jitted shared re-encode of one coefficient chunk (keyed only on
        the chunk shape and n, so the first/middle/tail commit steps and
        the opening gather all hit the same executable)."""
        fn = self._jit(("stream_encode", chunk.shape, n),
                       lambda c: self._encode_block_canon(c, k, n))
        return fn(chunk)

    def commit_columns_streaming(self, sc: StreamedCodewords):
        """Column commitment without materializing U: re-encode each
        coefficient chunk to canonical codewords on-device and absorb its
        bytes into per-column incremental Blake2s states.

        Bit-identical to :meth:`commit_columns` on the materialized matrix
        (same serialization: u64-LE element-count prefix + 32-byte LE
        canonical elements down each column; tested).  Peak HBM: one
        (chunk, n, L) codeword block + (n, 8) states.  The re-encode and
        the absorb are separate executables so the expensive NTT compile
        is shared with the opening gather and across chunk variants."""
        xp = self.xp
        rows, n, L = sc.shape
        rcm = sc.coeffs
        k = rcm.n
        words_per_row = L // 2  # 32 canonical LE bytes per element
        prefix = np.zeros(2, dtype=np.uint32)
        prefix[0] = rows & 0xFFFFFFFF
        prefix[1] = rows >> 32

        def make_absorb(r_c: int, first: bool):
            def absorb(canon, h_, carry_, t0_):
                cols = xp.moveaxis(canon[:r_c], 1, 0)           # (n, r_c, L)
                packed = cols[..., 0::2] | (cols[..., 1::2] << np.uint32(16))
                words = packed.reshape(n, r_c * words_per_row)
                head = (xp.broadcast_to(xp.asarray(prefix), (n, 2)) if first
                        else carry_)
                words = xp.concatenate([head, words], axis=-1)
                nb = words.shape[1] // 16  # carry-out is 2 or 10 words: != 0
                blocks = xp.moveaxis(
                    words[:, :16 * nb].reshape(n, nb, 16), 1, 0)
                h1 = self.hk.blake2s_stream_blocks(h_, blocks, t0_)
                return h1, words[:, 16 * nb:]
            return absorb

        h = self.hk.blake2s_stream_start(n)
        carry = xp.zeros((n, 2), np.uint32)  # ignored by the first step
        cw, t0, done = 2, 0, 0
        for ci, chunk in enumerate(rcm.chunks):
            r_c = min(rcm.chunk_rows, rows - done)
            done += r_c
            canon = self._stream_encode(chunk, k, n)
            fn = self._jit(("stream_absorb", ci == 0, canon.shape, r_c, cw, n),
                           make_absorb(r_c, ci == 0))
            h, carry = fn(canon, h, carry, np.uint32(t0))
            total_w = cw + r_c * words_per_row
            nb = total_w // 16
            t0 += 64 * nb
            cw = total_w - 16 * nb  # stays in {2, 10}: never a full block

        byte_len = 8 + rows * L * 2
        leaves_le = self.to_numpy(self._jit(
            ("stream_final", n, cw, byte_len),
            lambda h_, ca: self.hk.blake2s_stream_end(
                h_, xp.concatenate(
                    [ca, xp.zeros((n, 16 - cw), np.uint32)], axis=-1),
                byte_len))(h, carry))
        return self._digest_lists(leaves_le)

    def narrow16(self, a):
        """Device uint32 16-bit-limb array -> uint16 storage (halves the
        HBM residency of the chunked matrices; every limb is < 2^16 by
        representation invariant).  Consumers widen at the jit boundary."""
        return self._jit(("narrow16", a.shape), lambda x: x.astype(np.uint16))(a)

    @staticmethod
    def _widen(blk):
        import numpy as _np
        return blk.astype(_np.uint32) if blk.dtype == _np.uint16 else blk

    def _rows_source(self, a):
        """Row source for the chunked streaming paths: device arrays stay
        on-device (slice + pad with xp — no host round-trip), host arrays
        stay host (sliced per-chunk upload)."""
        if self.use_jax and not isinstance(a, np.ndarray):
            return a, self.xp
        return np.asarray(a), np

    def _rcm_column_block(self, rcm: RowChunkedMatrix, j0: int, j1: int):
        """All rows x columns [j0, j1) as one device array (rows, j1-j0, L)."""
        xp = self.xp
        blk = xp.concatenate([c[:, j0:j1] for c in rcm.chunks], axis=0)
        return self._widen(blk[:rcm.rows])

    def _rcm_row_block(self, rcm: RowChunkedMatrix, r0: int, r1: int,
                       pad_to: int):
        """Rows [r0, r1) (crossing chunk boundaries), zero-padded to
        ``pad_to`` rows, as one device array."""
        xp = self.xp
        parts = []
        i = r0
        while i < r1:
            ci, off = divmod(i, rcm.chunk_rows)
            take = min(rcm.chunk_rows - off, r1 - i)
            parts.append(rcm.chunks[ci][off:off + take])
            i += take
        if r1 - r0 < pad_to:
            parts.append(xp.zeros((pad_to - (r1 - r0), rcm.n, rcm.L),
                                  parts[0].dtype if parts else np.uint32))
        blk = parts[0] if len(parts) == 1 else xp.concatenate(parts, axis=0)
        return self._widen(blk)

    def gather_columns(self, u_canon, js) -> np.ndarray:
        """Columns ``js`` of a (rows, n, L) matrix -> (rows, len(js), L)
        numpy, gathering on-device (and transferring packed uint16 limbs)
        when the matrix is device-resident."""
        js = np.asarray(js, dtype=np.int64)
        if isinstance(u_canon, StreamedCodewords):
            xp = self.xp
            n, k = u_canon.n, u_canon.coeffs.n
            jdev = self.asarray(js.astype(np.int32))
            if self._use_mxu_spot(n, len(js)):
                # direct evaluation of the opened columns from the
                # coefficient chunks (canonical epilogue folded into the
                # REDC step count) — replaces the full per-chunk
                # re-encode; bit-identical (tested)
                w7 = self._spot_weights_dev(k, n, jdev)
                parts = [self._spot_block16(c, w7, n, True)
                         for c in u_canon.coeffs.chunks]
                out = self.to_numpy(self._concat_rows_dev(parts))
                return out[:u_canon.rows].astype(np.uint32)
            # re-encode each coefficient chunk (the SAME executable the
            # streaming commit compiled) and keep only the opened columns:
            # one (chunk, n, L) codeword transient at a time
            take = self._jit(
                ("stream_gather_cols", u_canon.coeffs.chunks[0].shape[0],
                 n, len(js)),
                lambda canon, j: xp.take(canon, j, axis=1).astype(np.uint16))
            parts = [take(self._stream_encode(c, k, n), jdev)
                     for c in u_canon.coeffs.chunks]
            out = self.to_numpy(self._concat_rows_dev(parts))
            return out[:u_canon.rows].astype(np.uint32)
        if isinstance(u_canon, RowChunkedMatrix):
            xp = self.xp
            jdev = self.asarray(js.astype(np.int32))
            # indices traced, not baked: fresh indices every proof
            take = self._jit(("rcm_take", u_canon.chunks[0].shape, len(js)),
                             lambda c, j: xp.take(c, j, axis=1).astype(np.uint16))
            parts = [take(c, jdev) for c in u_canon.chunks]
            out = self.to_numpy(self._concat_rows_dev(parts))[:u_canon.rows]
            return out.astype(np.uint32)
        if self.use_jax and not isinstance(u_canon, np.ndarray):
            jdev = self.xp.asarray(js.astype(np.int32))
            out = self.xp.take(u_canon, jdev, axis=1).astype(np.uint16)
            return self.to_numpy(out).astype(np.uint32)
        return np.ascontiguousarray(np.asarray(u_canon)[:, js, :])

    def to_mont(self, a):
        return self._jit(("to_mont", a.shape), self.fk.to_mont)(self.asarray(a))

    # ------------------------------------------------------------------
    # batched-proof helpers (LigeroCircuit.prove_batch): B proofs of the
    # same circuit share one device dispatch per bulk op
    # ------------------------------------------------------------------
    def commit_columns_batch(self, u_canon, B: int):
        """(B*rows, n, L) canonical limbs -> per-proof (leaves, levels).

        One Blake2s dispatch over all B*n columns (equal lengths) and one
        batched SHA-256 reduction per tree level; byte-identical to B
        separate :meth:`commit_columns` calls (tested)."""
        xp = self.xp
        BR, n, L = u_canon.shape
        rows = BR // B

        def leaves_fn(u):
            u4 = self._widen(u).reshape(B, rows, n, L)
            return self._hash_columns(
                xp.moveaxis(u4, 1, 0).reshape(rows, B * n, L))

        leaves_le = self._jit(("commit_b", B, u_canon.shape),
                              leaves_fn)(u_canon)

        def byteswap(x):
            return (((x & np.uint32(0xFF)) << np.uint32(24))
                    | ((x & np.uint32(0xFF00)) << np.uint32(8))
                    | ((x >> np.uint32(8)) & np.uint32(0xFF00))
                    | (x >> np.uint32(24)))

        def tree_fn(lv):
            level = byteswap(lv).reshape(B, n, 8)
            levels = []
            while level.shape[1] > 1:
                a = level[:, 0::2].reshape(-1, 8)
                b = level[:, 1::2].reshape(-1, 8)
                level = self.hk.sha256_two_to_one(a, b).reshape(
                    B, -1, 8)
                levels.append(level)
            return tuple(levels)

        levels_dev = self._jit(("tree_b", B, n), tree_fn)(leaves_le)
        leaves_np = self.to_numpy(leaves_le).reshape(B, n, 8)
        levels_np = [self.to_numpy(lv) for lv in levels_dev]
        out = []
        for b in range(B):
            leaves_b = [words_to_le_bytes(row) for row in leaves_np[b]]
            inner_b = [[be_words_to_bytes(r) for r in lv[b]]
                       for lv in levels_np]
            out.append((leaves_b, inner_b))
        return out

    def row_combine_batch(self, r, mats):
        """Per-proof challenge combinations: r (B, rows, L) x mats
        (B, rows, k, L) -> (B, k, L) Montgomery limbs."""

        def run(r_, m_):
            prod = self.fk.mont_mul(r_[:, :, None, :], m_)
            return self.fk.sum_mod(prod, axis=1)

        return self._jit16(("rowcomb_b", r.shape, mats.shape), run)(r, mats)

    def gather_columns_batch(self, u_canon, idx: np.ndarray) -> np.ndarray:
        """Per-proof column openings: u (B*rows, n, L) device array +
        idx (B, t) -> (B, rows, t, L) numpy (u16 on the wire)."""
        B, t = idx.shape
        xp = self.xp

        def run(u, j):
            u4 = self._widen(u).reshape(B, -1, u.shape[-2], u.shape[-1])
            return xp.take_along_axis(
                u4, j[:, None, :, None], axis=2).astype(np.uint16)

        out = self._jit(("gather_b", u_canon.shape, idx.shape), run)(
            u_canon, self.asarray(np.ascontiguousarray(idx, np.int32)))
        return self.to_numpy(out).astype(np.uint32)

    def _use_mxu_lc(self) -> bool:
        """Route the challenge combination through the int8 contraction
        (mxu_lc.py) on the GPU, for 16-limb fields."""
        return self.on_gpu and mxu_lc_ok(self.field)

    def _combine(self, r, mat):
        """Traced r^T · M for r (B, L), M (B, k, L) -> (k, L), all
        Montgomery: the int8 contraction on the GPU, Montgomery products
        and a tree sum elsewhere."""
        if self._use_mxu_lc():
            return mxu_lc(self.field, mat, r)
        return self.fk.sum_mod(self.fk.mont_mul(r[:, None, :], mat), axis=0)

    def row_combine(self, r, mat):
        """r^T · M for r (B, L), M (B, k, L) -> (k, L); all Montgomery.

        mont_mul self-chunks its batch (FieldKernel.MAX_BATCH_ELEMS), so no
        per-call-site chunking is needed here."""
        return self._jit16(("rowcomb", r.shape, mat.shape),
                           self._combine)(r, mat)

    def row_combine_coeffs(self, r, coeffs: RowChunkedMatrix):
        """Interleaved combination from the coefficient form: returns the
        message-space ``r^T . preenc`` (k, L) Montgomery limbs.

        ``sum_i r_i . row_i = NTT_k(sum_i r_i . coeffs_i)`` by linearity of
        the iNTT, so the streaming prover never needs the message matrix
        after encoding — bit-identical field elements to
        :meth:`row_combine` on the original rows (tested)."""
        xp = self.xp
        rows, k, L = coeffs.shape
        cr = coeffs.chunk_rows
        r_np = np.asarray(r)
        pad = len(coeffs.chunks) * cr - rows
        if pad:
            r_np = np.concatenate([r_np, np.zeros((pad, L), r_np.dtype)])

        def partial(m_, r_):
            prod = self.fk.mont_mul(r_[:, None, :], m_)
            return self.fk.sum_mod(prod, axis=0)

        parts = [self._jit16(("rcc_part", c.shape), partial)(
            c, np.ascontiguousarray(r_np[ci * cr:(ci + 1) * cr]))
            for ci, c in enumerate(coeffs.chunks)]
        total = self._jit(("rcc_sum", k, len(parts)),
                          lambda ps: self.fk.sum_mod(xp.stack(ps), axis=0))(parts)
        return self._jit(("rcc_ntt", k),
                         lambda t: self._fft_padded(t[None], k)[0])(total)

    def linear_combination_poly(self, u_coeffs, r_coeffs, two_k: int):
        """q = sum_i r_i(X) * u_i(X) via pointwise products on the 2k domain.

        Returns the 2k coefficient rows of q (Montgomery).  Matches the
        reference's poly-mul + sum (/root/reference/src/ligero/mod.rs:731-736)
        — deg q <= 2k-2 so the 2k-point cyclic convolution is exact.  Rows
        are summed, so large matrices stream in row chunks with a tiny
        (2k, L) partial per chunk (buffer-budget bound; zero-padded rows
        contribute zero).
        """
        def partial(u, r):
            eu = self._fft_padded(u, two_k)
            er = self._fft_padded(r, two_k)
            prod = self.fk.mont_mul(eu, er)
            return self.fk.sum_mod(prod, axis=0)

        def finish(total):
            return self._ifft(total[None], two_k)[0]

        if isinstance(u_coeffs, RowChunkedMatrix):
            # chunks are row-aligned with r; no part of u ever visits the
            # host.  r may itself be chunked (streaming-scale verifier) or
            # a host array (sliced per chunk — no single big upload)
            xp = self.xp
            rows, k_, L = u_coeffs.shape
            cr = u_coeffs.chunk_rows
            if isinstance(r_coeffs, RowChunkedMatrix):
                assert r_coeffs.rows == rows
                if r_coeffs.chunk_rows == cr:
                    r_blocks = r_coeffs.chunks
                else:  # re-chunk on device to match u's row blocks
                    r_blocks = [self._rcm_row_block(
                        r_coeffs, ci * cr, min((ci + 1) * cr, rows), cr)
                        for ci in range(len(u_coeffs.chunks))]
            elif isinstance(r_coeffs, np.ndarray):
                pad = len(u_coeffs.chunks) * cr - rows
                r_np = (np.concatenate(
                    [r_coeffs, np.zeros((pad, k_, L), r_coeffs.dtype)])
                    if pad else r_coeffs)
                r_blocks = [np.ascontiguousarray(r_np[ci * cr:(ci + 1) * cr])
                            for ci in range(len(u_coeffs.chunks))]
            else:
                r_dev = r_coeffs
                pad = len(u_coeffs.chunks) * cr - rows
                if pad:
                    r_dev = xp.concatenate(
                        [r_dev, xp.zeros((pad, k_, L), np.uint32)], axis=0)
                r_blocks = [r_dev[ci * cr:(ci + 1) * cr]
                            for ci in range(len(u_coeffs.chunks))]
            parts = [self._jit16(("linq_part", two_k, uc.shape), partial)(
                uc, r_blocks[ci])
                for ci, uc in enumerate(u_coeffs.chunks)]
            total = self._jit(("linq_sum", two_k, len(parts)),
                              lambda ps: self.fk.sum_mod(self.xp.stack(ps), axis=0))(parts)
            return self._jit(("linq_fin", two_k), finish)(total)

        B, _, L = u_coeffs.shape
        r_is_rcm = isinstance(r_coeffs, RowChunkedMatrix)  # zk prover mixes
        if self.use_jax and B * two_k * L * 4 > self.MAX_DEVICE_BYTES:
            chunk = max(8, self.MAX_DEVICE_BYTES // (two_k * L * 4))
            u_host, xpu = self._rows_source(u_coeffs)
            r_host = None if r_is_rcm else np.asarray(r_coeffs)
            parts = []
            for i in range(0, B, chunk):
                ub = u_host[i:i + chunk]
                if r_is_rcm:
                    rb = self._rcm_row_block(r_coeffs, i, min(i + chunk, B),
                                             chunk)
                else:
                    rb = r_host[i:i + chunk]
                    if rb.shape[0] < chunk:
                        rb = np.concatenate(
                            [rb, np.zeros((chunk - rb.shape[0],) + rb.shape[1:],
                                          np.uint32)])
                if ub.shape[0] < chunk:
                    ub = xpu.concatenate(
                        [ub, xpu.zeros((chunk - ub.shape[0],) + tuple(ub.shape[1:]),
                                       ub.dtype)])
                parts.append(self._jit16(("linq_part", two_k, ub.shape), partial)(ub, rb))
            total = self._jit(("linq_sum", two_k, len(parts)),
                              lambda ps: self.fk.sum_mod(self.xp.stack(ps), axis=0))(parts)
            return self._jit(("linq_fin", two_k), finish)(total)

        if r_is_rcm:
            r_coeffs = self._rcm_row_block(r_coeffs, 0, B, B)

        def run(u, r):
            return finish(partial(u, r))

        return self._jit16(("linq", two_k, u_coeffs.shape), run)(
            u_coeffs, r_coeffs)

    def quadratic_combination_poly(self, xyz_coeffs, r_quad, two_k: int,
                                   m: int | None = None):
        """p0 = sum_i r_i * (px_i * py_i - pz_i) on the 2k domain.

        ``xyz_coeffs`` is (3m, k, L) — or the full device-resident
        (4m, k, L) ``RowChunkedMatrix`` with ``m`` given, whose x/y/z row
        blocks are assembled on the device.  Matches reference
        mod.rs:845-848.  Streams in m-chunks when large (same budget rule
        as ``linear_combination_poly``; padded rows are exact zeros).
        """
        def partial(x, y, z, r):
            ex = self._fft_padded(x, two_k)
            ey = self._fft_padded(y, two_k)
            ez = self._fft_padded(z, two_k)
            term = self.fk.sub(self.fk.mont_mul(ex, ey), ez)
            weighted = self.fk.mont_mul(r[:, None, :], term)
            return self.fk.sum_mod(weighted, axis=0)

        def finish(total):
            return self._ifft(total[None], two_k)[0]

        if isinstance(xyz_coeffs, RowChunkedMatrix):
            assert m is not None, "RowChunkedMatrix path needs explicit m"
            L = xyz_coeffs.L
            chunk = min(m, max(8, self.MAX_DEVICE_BYTES // (3 * two_k * L * 4)))
            r_host = np.asarray(r_quad)
            parts = []
            for i in range(0, m, chunk):
                end = min(i + chunk, m)
                xb = self._rcm_row_block(xyz_coeffs, i, end, chunk)
                yb = self._rcm_row_block(xyz_coeffs, m + i, m + end, chunk)
                zb = self._rcm_row_block(xyz_coeffs, 2 * m + i, 2 * m + end, chunk)
                rb = r_host[i:end]
                if end - i < chunk:
                    rb = np.concatenate(
                        [rb, np.zeros((chunk - (end - i), rb.shape[1]), np.uint32)])
                parts.append(self._jit16(("quadp_part", two_k, xb.shape), partial)(
                    xb, yb, zb, rb))
            total = self._jit(("quadp_sum", two_k, len(parts)),
                              lambda ps: self.fk.sum_mod(self.xp.stack(ps), axis=0))(parts)
            return self._jit(("quadp_fin", two_k), finish)(total)

        three_m, _, L = xyz_coeffs.shape
        m = three_m // 3
        if self.use_jax and three_m * two_k * L * 4 > self.MAX_DEVICE_BYTES:
            # chunk <= m: slices must not cross the x/y/z region boundaries
            chunk = min(m, max(8, self.MAX_DEVICE_BYTES // (3 * two_k * L * 4)))
            xyz_host, xpu = self._rows_source(xyz_coeffs)
            r_host = np.asarray(r_quad)
            parts = []
            for i in range(0, m, chunk):
                # slices stop at each region's end — a partial last chunk
                # must not spill into the next region
                end = min(i + chunk, m)
                xb = xyz_host[i:end]
                yb = xyz_host[m + i:m + end]
                zb = xyz_host[2 * m + i:2 * m + end]
                rb = r_host[i:end]
                if xb.shape[0] < chunk:
                    pad = chunk - xb.shape[0]
                    zpad = xpu.zeros((pad,) + tuple(xb.shape[1:]), xb.dtype)
                    xb, yb, zb = (xpu.concatenate([v, zpad])
                                  for v in (xb, yb, zb))
                    rb = np.concatenate(
                        [rb, np.zeros((pad, rb.shape[1]), np.uint32)])
                parts.append(self._jit16(("quadp_part", two_k, xb.shape), partial)(
                    xb, yb, zb, rb))
            total = self._jit(("quadp_sum", two_k, len(parts)),
                              lambda ps: self.fk.sum_mod(self.xp.stack(ps), axis=0))(parts)
            return self._jit(("quadp_fin", two_k), finish)(total)

        def run(xyz, r):
            ev = self._fft_padded(xyz, two_k)
            ex, ey, ez = ev[:m], ev[m:2 * m], ev[2 * m:]
            term = self.fk.sub(self.fk.mont_mul(ex, ey), ez)
            weighted = self.fk.mont_mul(r[:, None, :], term)
            total = self.fk.sum_mod(weighted, axis=0)
            return self._ifft(total[None], two_k)[0]

        return self._jit16(("quadp", two_k, xyz_coeffs.shape), run)(
            xyz_coeffs, r_quad)

    # chunk budget of the chunked paths: the largest row or column block
    # the resident and streaming paths build at once.  A chunk size, not
    # a device limit; whether larger chunks are faster on the GPU is
    # unmeasured (ROADMAP 3.2)
    MAX_DEVICE_BYTES = 1 << 28

    def _hash_columns(self, u):
        """(rows, nc, L) canonical limbs (traced) -> (nc, 8) LE Blake2s
        digest words of each column, serialized as a u64-LE row count
        then each element's 32 canonical LE bytes: the Triton kernel on
        the GPU, HashKernel elsewhere."""
        if self.on_gpu:
            return blake2s_columns(u)
        return self._hash_columns_xla(u)

    def _hash_columns_xla(self, u):
        """:meth:`_hash_columns` by HashKernel (serialize, then one
        batched Blake2s over the column messages)."""
        xp = self.xp
        rows, nc, L = u.shape
        byte_len = 8 + rows * L * 2
        pad_words = (-(2 + rows * (L // 2))) % 16
        prefix = np.zeros(2, dtype=np.uint32)
        prefix[0] = rows & 0xFFFFFFFF
        prefix[1] = rows >> 32
        cols = xp.moveaxis(u, 1, 0)  # (nc, rows, L)
        packed = cols[..., 0::2] | (cols[..., 1::2] << np.uint32(16))
        words = packed.reshape(nc, -1)
        pre = xp.broadcast_to(xp.asarray(prefix), (nc, 2))
        words = xp.concatenate(
            [pre, words, xp.zeros((nc, pad_words), np.uint32)], axis=-1)
        return self.hk.blake2s(words, byte_len)  # (nc, 8) LE words

    def _column_leaves_device(self, u_canon):
        """(rows, nc, L) canonical limbs -> (nc, 8) LE Blake2s digest words.

        ``rows`` must be the full element count 4m (the u64-LE length
        prefix); column chunking along n is free since columns hash
        independently.
        """
        return self._jit16(("leaves", u_canon.shape),
                           self._hash_columns)(u_canon)

    def _tree_levels(self, leaves_le):
        """(n, 8) LE leaf digest words -> tuple of SHA-256 level arrays."""
        def byteswap(x):
            return (((x & np.uint32(0xFF)) << np.uint32(24))
                    | ((x & np.uint32(0xFF00)) << np.uint32(8))
                    | ((x >> np.uint32(8)) & np.uint32(0xFF00))
                    | (x >> np.uint32(24)))

        def run(lv):
            level = byteswap(lv)  # BE words for sha
            levels = []
            while level.shape[0] > 1:
                level = self.hk.sha256_two_to_one(level[0::2], level[1::2])
                levels.append(level)
            return tuple(levels)

        return self._jit(("tree", leaves_le.shape), run)(self.asarray(leaves_le))

    def _tree_flat(self, leaves_le):
        """(n, 8) LE leaf words -> ONE flat uint32 vector: the leaves'
        LE words followed by every SHA-256 level's BE words bottom-up.
        A single device->host transfer replaces one per tree level —
        each per-level download is its own device->host transfer (~13
        levels at n=8192)."""
        def byteswap(x):
            return (((x & np.uint32(0xFF)) << np.uint32(24))
                    | ((x & np.uint32(0xFF00)) << np.uint32(8))
                    | ((x >> np.uint32(8)) & np.uint32(0xFF00))
                    | (x >> np.uint32(24)))

        def run(lv):
            xp = self.xp
            parts = [lv.reshape(-1)]
            level = byteswap(lv)  # BE words for sha
            while level.shape[0] > 1:
                level = self.hk.sha256_two_to_one(level[0::2], level[1::2])
                parts.append(level.reshape(-1))
            return xp.concatenate(parts) if len(parts) > 1 else parts[0]

        return self._jit(("tree_flat", leaves_le.shape),
                         run)(self.asarray(leaves_le))

    def _digest_lists(self, leaves_le):
        """(n, 8) LE leaf words (device or host) -> ark-layout
        ``(leaves: list[bytes], inner: list[list[bytes]])`` via the fused
        flat transfer + vectorized byte packing (the former per-row
        ``words_to_le_bytes`` loop cost ~10 us x 2n rows per proof)."""
        n = int(leaves_le.shape[0])
        flat = np.asarray(self.to_numpy(self._tree_flat(leaves_le)),
                          dtype=np.uint32)
        leaves_raw = flat[:n * 8].astype("<u4").tobytes()
        leaves = [leaves_raw[i * 32:(i + 1) * 32] for i in range(n)]
        inner_raw = flat[n * 8:].astype(">u4").tobytes()
        inner, off, size = [], 0, n // 2
        while size >= 1:
            inner.append([inner_raw[(off + i) * 32:(off + i + 1) * 32]
                          for i in range(size)])
            off += size
            if size == 1:
                break
            size //= 2
        return leaves, inner

    def commit_columns(self, u_canon):
        """Column commitment: Blake2s column leaves + SHA-256 Merkle levels,
        all batched on the device.

        ``u_canon``: (4m, n, L) canonical limbs (device array or numpy).
        Returns ``(leaf_digests: list[bytes], inner_levels: list[list[bytes]])``
        with ark-compatible byte layouts (see ligero_jax.hashes).  When the
        matrix exceeds the single-buffer budget it is hashed in column
        chunks (columns are independent; only the tiny digest rows leave
        the device per chunk).
        """
        if isinstance(u_canon, StreamedCodewords):
            return self.commit_columns_streaming(u_canon)
        if isinstance(u_canon, RowChunkedMatrix):
            rows, n, L = u_canon.shape
            if self.on_gpu:
                # every column in one kernel launch: the kernel runs one
                # column per thread, so a column block of the chunk
                # budget (~900 columns) would leave most of the card idle
                # (PERF.md)
                chunks = tuple(u_canon.chunks)
                fn = self._jit(
                    ("leaves_rcm", rows, len(chunks), chunks[0].shape),
                    lambda *cs: blake2s_columns(
                        self.xp.concatenate(cs)[:rows].astype(np.uint32)))
                return self._digest_lists(self.to_numpy(fn(*chunks)))
            # assemble column blocks on-device from the resident chunks;
            # only the digest rows (32 B/column) ever leave the device
            nc = min(max(1, self.MAX_DEVICE_BYTES // (rows * L * 4)), n)
            parts = [self.to_numpy(self._column_leaves_device(
                self._rcm_column_block(u_canon, j, min(j + nc, n))))
                for j in range(0, n, nc)]
            leaves_le = np.concatenate(parts, axis=0)
            return self._digest_lists(leaves_le)
        four_m, n, L = u_canon.shape
        total_bytes = four_m * n * L * 4
        if self.use_jax and total_bytes > self.MAX_DEVICE_BYTES:
            nc = max(1, self.MAX_DEVICE_BYTES // (four_m * L * 4))
            if self.on_gpu and nc >= TILE:
                nc = nc // TILE * TILE  # whole kernel tiles: no padding
            nc = min(nc, n)
            u_host = self.to_numpy(u_canon) if not isinstance(u_canon, np.ndarray) else u_canon
            parts = [self.to_numpy(self._column_leaves_device(
                np.ascontiguousarray(u_host[:, j:j + nc, :])))
                for j in range(0, n, nc)]
            leaves_le = np.concatenate(parts, axis=0)
        else:
            leaves_le = self._column_leaves_device(u_canon)
        return self._digest_lists(leaves_le)

    # ------------------------------------------------------------------
    # device challenge expansion + sparse r^T A (linear phase, FS #5)
    # ------------------------------------------------------------------
    def rand_field_mont(self, count: int, seed: bytes, narrow: bool = False):
        """``F::rand`` challenge expansion on the device.

        Bit-identical to :func:`ligero_jax.sampling.rand_field_elements_limbs`
        (same ChaCha20 stream, same rejection order — tested).  Returns a
        device ``(count, L)`` uint32 limb array — or, with
        ``narrow=True``, a LIMB-MAJOR ``(L, count)`` uint16 array from
        the word-major sampler (same values; half the HBM and layouts
        that avoid the (attempts, 8) lane-padding OOM at 2^22 — see
        devsampler.fr_sample_device_wordmajor).  ``None`` on attempt
        shortfall (probability hundreds of sigma below mean) or when the
        narrow layout doesn't support the field's limb count; callers
        fall back to the host sampler, preserving exactness."""
        from .devsampler import fr_sample_device, fr_sample_device_wordmajor
        key = np.frombuffer(seed, dtype="<u4").astype(np.uint32)
        if narrow:
            if 2 * self.field.num_u64_limbs != 8:
                return None
            fn = self._jit(("fr_sample_wm", count),
                           lambda kw: fr_sample_device_wordmajor(
                               self.xp, self.field, kw, count))
        else:
            fn = self._jit(("fr_sample", count),
                           lambda kw: fr_sample_device(self.xp, self.field,
                                                       kw, count))
        limbs, accepted = fn(self.asarray(key))
        if int(accepted) < count:
            return None
        return limbs

    def sparse_rA_mont(self, rowids, colids, vals_mont, r_mont, num_cols: int):
        """``out[col] += vals[i] * r[rowids[i]]`` mod p, fully on device.

        All operands Montgomery 16-bit limbs.  The per-column sums
        accumulate raw u32 limb columns (requires max column multiplicity
        * 0xFFFF < 2^32 — asserted by the caller), then reduce exactly:
        value = LO + 2^16*HI with LO/HI normalized 16-limb numbers < R,
        so  value mod p = mont_mul(LO, R mod p) + mont_mul(HI, 2^16 R mod p)
        (mont_mul accepts any a < R for b < p; output canonical).
        Matches native.sparse_row_mul_mont bit-for-bit (tested)."""
        y0 = self.field.ints_to_limbs([self.field.to_mont(1)])[0]
        y1 = self.field.ints_to_limbs([self.field.to_mont(1 << 16)])[0]

        def raw_sums(vals, rids, cids, r):
            xp = self.xp
            gathered = xp.take(r, rids, axis=0).astype(np.uint32)
            vals = vals.astype(np.uint32)
            prod = self.fk.mont_mul(vals, gathered)
            if self.use_jax:
                return self._jax.ops.segment_sum(
                    prod, cids, num_segments=num_cols,
                    indices_are_sorted=True)
            sums = np.zeros((num_cols, prod.shape[-1]), np.uint32)
            np.add.at(sums, cids, prod)
            return sums

        def fold(sums):
            xp = self.xp
            L = sums.shape[-1]
            lo, hi = sums & np.uint32(0xFFFF), sums >> np.uint32(16)
            return self.fk.add(
                self.fk.mont_mul(lo, xp.broadcast_to(self.asarray(y0),
                                                     (num_cols, L))),
                self.fk.mont_mul(hi, xp.broadcast_to(self.asarray(y1),
                                                     (num_cols, L))))

        nnz = int(rowids.shape[0])
        # chunk so the (nnz, L)-sized product/gather temporaries stay
        # bounded (~4 buffers x nnz x 64 B — 4 GB at the 2^21 scale)
        chunk = 1 << 22
        if not self.use_jax or nnz <= chunk:
            def run_all(vals, rids, cids, r):
                return fold(raw_sums(vals, rids, cids, r))
            fn = self._jit(("sparse_rA", nnz, num_cols), run_all)
            return fn(vals_mont, rowids, colids, r_mont)

        sums_fn = self._jit(("sparse_rA_chunk", chunk, num_cols), raw_sums)
        acc = None
        for i in range(0, nnz, chunk):
            v = vals_mont[i:i + chunk]
            ri = rowids[i:i + chunk]
            ci = colids[i:i + chunk]
            cnt = int(v.shape[0])
            if cnt < chunk:  # zero-value padding contributes nothing
                xp = self.xp
                v = xp.concatenate(
                    [v, xp.zeros((chunk - cnt, v.shape[1]), v.dtype)])
                ri = xp.concatenate(
                    [ri, xp.zeros((chunk - cnt,), ri.dtype)])
                # pad with the LAST column id: zero values contribute
                # nothing and the ids stay sorted for segment_sum
                ci = xp.concatenate(
                    [ci, xp.full((chunk - cnt,), num_cols - 1, ci.dtype)])
            part = sums_fn(v, ri, ci, r_mont)
            acc = part if acc is None else acc + part  # exact u32 sums
        return self._jit(("sparse_rA_fold", num_cols), fold)(acc)

    def sparse_rA_mont_blocked(self, rowids, colids, vals_mont, r_mont,
                               num_cols: int, block_cols: int,
                               host_cols: np.ndarray):
        """Column-blocked ``r^T·A``: yields canonical ``(block_cols, L)``
        device blocks of the product, in column order.

        The 2^22-scale variant of :meth:`sparse_rA_mont`: the full
        ``(num_cols, L)`` u32 output (2.15 GB at 4mk = 33.6M) would pass
        the chunk budget (MAX_DEVICE_BYTES), so the output column space is
        processed in ``block_cols``-wide blocks (the caller iNTTs each
        into a RowChunkedMatrix row chunk).  ``host_cols`` is the host
        copy of the column-sorted ``colids`` (block entry ranges come
        from one searchsorted).  Same u32 accumulation + exact fold as
        ``sparse_rA_mont`` — per-block segment sums see the same entries
        in the same order, so the result is bit-identical.  The final
        partial block is zero-padded to ``block_cols`` (padded columns
        fold to canonical zeros; the caller's row accounting masks them).

        Entry chunks pad to a power-of-two bucket (2^19..2^22) so at most
        four kernel shapes ever compile, regardless of per-block density
        skew (the w-section blocks of A carry most of the mass)."""
        xp = self.xp
        L = self.field.num_limbs
        y0 = self.field.ints_to_limbs([self.field.to_mont(1)])[0]
        y1 = self.field.ints_to_limbs([self.field.to_mont(1 << 16)])[0]

        def raw_sums_blk(vals, rids, cids, c0, r):
            # r is LIMB-MAJOR (L, count) u16 (the word-major sampler's
            # layout); the gathered entry chunk is small, so the
            # transpose back to entry-major costs nothing
            gathered = xp.transpose(xp.take(r, rids, axis=1),
                                    (1, 0)).astype(np.uint32)
            vals = vals.astype(np.uint32)
            prod = self.fk.mont_mul(vals, gathered)
            return self._jax.ops.segment_sum(
                prod, cids - c0, num_segments=block_cols,
                indices_are_sorted=True)

        def fold_blk(sums):
            lo, hi = sums & np.uint32(0xFFFF), sums >> np.uint32(16)
            return self.fk.add(
                self.fk.mont_mul(lo, xp.broadcast_to(self.asarray(y0),
                                                     (block_cols, L))),
                self.fk.mont_mul(hi, xp.broadcast_to(self.asarray(y1),
                                                     (block_cols, L))))

        fold_fn = self._jit(("sparse_rA_blk_fold", block_cols), fold_blk)
        n_blocks = -(-num_cols // block_cols)
        bounds = np.searchsorted(
            host_cols, np.arange(n_blocks + 1, dtype=np.int64) * block_cols)
        q_min, q_max = 1 << 19, 1 << 22
        for bi in range(n_blocks):
            c0 = bi * block_cols
            e0, e1 = int(bounds[bi]), int(bounds[bi + 1])
            if e0 == e1:
                yield xp.zeros((block_cols, L), np.uint32)
                continue
            c0_dev = np.int32(c0)
            acc = None
            i = e0
            while i < e1:
                rem = e1 - i
                q = q_max if rem >= q_max else max(
                    q_min, 1 << (rem - 1).bit_length())
                cnt = min(rem, q)
                v = vals_mont[i:i + cnt]
                ri = rowids[i:i + cnt]
                ci = colids[i:i + cnt]
                if cnt < q:  # zero-value padding contributes nothing
                    v = xp.concatenate(
                        [v, xp.zeros((q - cnt, v.shape[1]), v.dtype)])
                    ri = xp.concatenate(
                        [ri, xp.zeros((q - cnt,), ri.dtype)])
                    # pad with the block's LAST column id: keeps the ids
                    # sorted; zero values contribute nothing
                    ci = xp.concatenate(
                        [ci, xp.full((q - cnt,), c0 + block_cols - 1,
                                     ci.dtype)])
                part = self._jit(("sparse_rA_blk", q, block_cols),
                                 raw_sums_blk)(v, ri, ci, c0_dev, r_mont)
                acc = part if acc is None else acc + part  # exact u32
                i += cnt
            yield fold_fn(acc)

    # ------------------------------------------------------------------
    # host <-> device value conversion helpers
    # ------------------------------------------------------------------
    def ints_to_mont(self, ints: list[int]) -> np.ndarray:
        return self.field.ints_to_mont_limbs(ints)

    def mont_to_ints(self, limbs) -> list[int]:
        return self.field.mont_limbs_to_ints(self.to_numpy(limbs))

    def canon_limbs_to_ints(self, limbs) -> list[int]:
        return self.field.limbs_to_ints(self.to_numpy(limbs))
