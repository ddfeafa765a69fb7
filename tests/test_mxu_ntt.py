"""Four-step NTT: validation of the exact integer path.

mxu_ntt_numpy runs the SAME shared numeric core as the device route
(7-bit limb matmuls, shifted base-2^7 accumulation, regroup, 17-step
REDC, R*2^32 twiddle compensation) with numpy standing in for the int8
dot — bit-compared against the production DomainOps NTT; the jitted
device route (ntt_fourstep / ntt_fourstep_any) is compared the same
way."""

import numpy as np
import pytest

from ligero_jax.engine.fieldops import FieldKernel
from ligero_jax.engine.mxu_ntt import mxu_ntt_numpy, split_n
from ligero_jax.engine.ntt import DomainOps
from ligero_jax.fields import BN254_FR

F = BN254_FR


def test_split_n():
    assert split_n(1024) == (32, 32)
    assert split_n(2048) == (64, 32)
    assert split_n(4096) == (128, 32)
    assert split_n(8192) == (128, 64)
    assert split_n(16384) == (128, 128)


@pytest.mark.parametrize("n", [64, 256, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_mxu_ntt_matches_domain_ops(n, inverse):
    fk = FieldKernel(F, np)
    dom = DomainOps(fk, n)
    rng = np.random.default_rng(n + inverse)
    limbs = F.ints_to_mont_limbs(
        [int(v) for v in rng.integers(0, 2 ** 62, 2 * n)]
    ).reshape(2, n, F.num_limbs)
    ref = np.asarray(dom.ifft(limbs) if inverse else dom.fft_padded(limbs))
    got = mxu_ntt_numpy(F, limbs, n, inverse=inverse)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("n", [256, 2048])
def test_mxu_ntt_canon_out(n):
    """canon_out folds R^-1 into the stage-2 twiddle: the kernel emits
    canonical limbs directly (the fused from-mont commit epilogue)."""
    fk = FieldKernel(F, np)
    dom = DomainOps(fk, n)
    rng = np.random.default_rng(7 * n)
    limbs = F.ints_to_mont_limbs(
        [int(v) for v in rng.integers(0, 2 ** 62, 2 * n)]
    ).reshape(2, n, F.num_limbs)
    mont = np.asarray(dom.fft_padded(limbs))
    ref = F.ints_to_limbs(F.mont_limbs_to_ints(mont.reshape(-1, F.num_limbs))
                          ).reshape(mont.shape)
    got = mxu_ntt_numpy(F, limbs, n, canon_out=True)
    assert np.array_equal(got, ref)


def test_mxu_ntt_edge_values():
    """p-1 / 0 / 1 operands stress the REDC bound (T max when all
    operands are ~p)."""
    n = 256
    fk = FieldKernel(F, np)
    dom = DomainOps(fk, n)
    vals = [F.p - 1] * (n // 2) + [0, 1] * (n // 4)
    limbs = F.ints_to_mont_limbs(vals).reshape(1, n, F.num_limbs)
    assert np.array_equal(mxu_ntt_numpy(F, limbs, n),
                          np.asarray(dom.fft_padded(limbs)))


def test_fused_stage_matches_loop_form():
    """The single-matmul fused stage (limbs in the contraction) is
    bit-identical to one matmul per constant limb m whose product adds
    into redundant columns m..m+L7-1."""
    from ligero_jax.engine.mxu_ntt import (
        L7, _const_data, _fuse_w_left, _fuse_w_right, _limbs16_to_7,
        _np_dot_i32, _stage_matmul)

    def loop_form(w7, d7, data_left):
        _, rows, cols = d7.shape
        out = np.zeros((2 * L7 - 1, rows, cols), np.uint32)
        for m in range(L7):
            for la in range(L7):
                out[m + la] += (_np_dot_i32(d7[la], w7[m]) if data_left
                                else _np_dot_i32(w7[m], d7[la]))
        return out

    n = 1024
    w2, w1, _t16 = _const_data(F.name, n, False)
    rng = np.random.default_rng(5)
    n1, n2 = split_n(n)
    x = F.ints_to_mont_limbs(
        [int(v) % F.p for v in rng.integers(0, 2 ** 63, n)]
    ).reshape(n2, n1, F.num_limbs).transpose(2, 0, 1)  # (L, n2, n1)
    d7 = _limbs16_to_7(np, x)
    fused = _stage_matmul(np, _np_dot_i32, _fuse_w_right(w2), d7,
                          data_left=False)
    assert np.array_equal(fused, loop_form(w2, d7, data_left=False))
    fused = _stage_matmul(np, _np_dot_i32, _fuse_w_left(w1), d7,
                          data_left=True)
    assert np.array_equal(fused, loop_form(w1, d7, data_left=True))


def test_radix2_split_math_matches_domain_ops():
    """The Cooley-Tukey split wrapper's math (even/odd leaves, Montgomery
    twiddle combine, per-level inverse 1/2 via extra_shift, canon_out
    threading) replayed with numpy leaves — bit-compared to DomainOps."""
    from ligero_jax.engine.mxu_ntt import _split_twiddles, mxu_ntt_numpy

    fk = FieldKernel(F, np)
    leaf = 512

    def np_split(x, n, inverse, canon_out, shift):
        if n <= leaf:
            return mxu_ntt_numpy(F, x, n, inverse, canon_out,
                                  extra_shift=shift)
        half = n // 2
        sub = shift + (1 if inverse else 0)
        e = np_split(x[:, 0::2], half, inverse, canon_out, sub)
        o = np_split(x[:, 1::2], half, inverse, canon_out, sub)
        tw = _split_twiddles(F.name, n, inverse)[None]
        t_o = fk.mont_mul(o, np.broadcast_to(tw, o.shape))
        return np.concatenate([fk.add(e, t_o), fk.sub(e, t_o)], axis=1)

    rng = np.random.default_rng(11)
    for n in (1024, 2048):
        dom = DomainOps(fk, n)
        x = F.ints_to_mont_limbs(
            [int(v) % F.p for v in rng.integers(0, 2 ** 63, 2 * n)]
        ).reshape(2, n, F.num_limbs)
        assert np.array_equal(np_split(x, n, False, False, 0),
                              np.asarray(dom.fft_padded(x)))
        assert np.array_equal(np_split(x, n, True, False, 0),
                              np.asarray(dom.ifft(x)))
        # canonical epilogue through the split
        mont = np.asarray(dom.fft_padded(x))
        ref = F.ints_to_limbs(
            F.mont_limbs_to_ints(mont.reshape(-1, F.num_limbs))
        ).reshape(mont.shape)
        assert np.array_equal(np_split(x, n, False, True, 0), ref)


def test_post_root_folding_matches_explicit_twiddle():
    """post_root_n folds the split's odd-branch twiddle w_{2n}^{k} into
    the leaf constants (stage-2 twiddle x stage-3 column scale) — must
    equal NTT followed by an explicit Montgomery twiddle multiply."""
    from ligero_jax.engine.mxu_ntt import _split_twiddles, mxu_ntt_numpy

    fk = FieldKernel(F, np)
    n, parent = 512, 1024
    rng = np.random.default_rng(23)
    x = F.ints_to_mont_limbs(
        [int(v) % F.p for v in rng.integers(0, 2 ** 63, 2 * n)]
    ).reshape(2, n, F.num_limbs)
    for inverse in (False, True):
        plain = mxu_ntt_numpy(F, x, n, inverse=inverse)
        tw = _split_twiddles(F.name, parent, inverse)[None]
        want = fk.mont_mul(plain, np.broadcast_to(tw, plain.shape))
        got = mxu_ntt_numpy(F, x, n, inverse=inverse, post_root_n=parent)
        assert np.array_equal(got, want)
    # composes with the canonical epilogue
    plain = mxu_ntt_numpy(F, x, n, canon_out=True)
    tw = _split_twiddles(F.name, parent, False)[None]
    want = fk.mont_mul(plain, np.broadcast_to(tw, plain.shape))
    got = mxu_ntt_numpy(F, x, n, canon_out=True, post_root_n=parent)
    assert np.array_equal(got, want)


def test_cios_mont_mul_matches_sos():
    """The CIOS-interleaved Montgomery product is bit-identical to the
    separate product+REDC formulation (canonical output is unique)."""
    from ligero_jax.engine.mxu_ntt import _FieldVm

    fv = _FieldVm(np, F)
    rng = np.random.default_rng(31)
    vals = [int(v) % F.p for v in rng.integers(0, 2 ** 63, 2 * 512)]
    vals[:6] = [0, 1, F.p - 1, F.p - 1, 1, 0]
    limbs = F.ints_to_mont_limbs(vals).reshape(2, 4, 128, F.num_limbs)
    a = np.ascontiguousarray(limbs[0].transpose(2, 0, 1))  # (L, 4, 128)
    b = np.ascontiguousarray(limbs[1].transpose(2, 0, 1))
    assert np.array_equal(fv.mont_mul_cios(a, b), fv.mont_mul(a, b))


def test_fold_redc_bit_exact_kernel_paths():
    """FOLD_REDC variant: the data-parallel fold REDC is bit-identical
    to the serial 17-step chain through the whole numpy path (forward,
    inverse, canonical epilogue)."""
    import numpy as np

    import ligero_jax.engine.mxu_ntt as mx
    from ligero_jax.fields import BN254_FR as F

    rng = np.random.default_rng(11)
    n = 2048
    x = F.ints_to_mont_limbs(
        [int(v) for v in rng.integers(0, 2 ** 62, 2 * n)]
    ).reshape(2, n, F.num_limbs).astype(np.uint32)
    old = mx.FOLD_REDC
    try:
        variants = {}
        for fold in (False, True):
            mx.FOLD_REDC = fold
            variants[fold] = [mx.mxu_ntt_numpy(F, x, n),
                              mx.mxu_ntt_numpy(F, x, n, inverse=True),
                              mx.mxu_ntt_numpy(F, x, n, canon_out=True)]
        for a, b in zip(variants[False], variants[True]):
            assert np.array_equal(a, b)
    finally:
        mx.FOLD_REDC = old


def test_mxu_gate_excludes_wide_fields():
    """BLS12-377 Fq (24 limbs) must not route onto the four-step NTT:
    the int8 limb split is sized for 16-limb operands (< 2^259) and
    would silently truncate wider moduli."""
    from ligero_jax.engine.mxu_ntt import mxu_any_ok
    from ligero_jax.fields import BLS12_377_FQ, BN254_FR

    assert mxu_any_ok(2048, BN254_FR)
    assert not mxu_any_ok(2048, BLS12_377_FQ)
    assert not mxu_any_ok(8192, BLS12_377_FQ)


def test_mxu_lc_numpy_bit_exact():
    """int8 challenge combination (mxu_lc.py): numpy spec
    bit-compared against the host Montgomery kernel, incl. the row-chunk
    combine and max-density operands (bound stress)."""
    import numpy as np

    from ligero_jax.engine.fieldops import FieldKernel
    from ligero_jax.engine.mxu_lc import ROWS_MAX, mxu_lc_numpy
    from ligero_jax.fields import BN254_FR as F

    rng = np.random.default_rng(9)
    fk = FieldKernel(F, np)
    for rows, k in ((64, 32), (300, 16), (ROWS_MAX + 100, 8)):
        preenc = F.ints_to_mont_limbs(
            [int(v) for v in rng.integers(0, 2 ** 63, rows * k)]
        ).reshape(rows, k, F.num_limbs).astype(np.uint32)
        r = F.ints_to_mont_limbs(
            [int(v) for v in rng.integers(0, 2 ** 63, rows)]).astype(np.uint32)
        ref = fk.sum_mod(fk.mont_mul(r[:, None, :], preenc), axis=0)
        assert np.array_equal(np.asarray(ref, np.uint32),
                              mxu_lc_numpy(F, preenc, r)), (rows, k)
    # max limb density (p-1 everywhere): accumulation bounds hold
    rows, k = 512, 8
    pm1 = F.p - 1
    preenc = np.tile(F.ints_to_mont_limbs([pm1] * k).reshape(1, k, -1),
                     (rows, 1, 1)).astype(np.uint32)
    r = np.tile(F.ints_to_mont_limbs([pm1]), (rows, 1)).astype(np.uint32)
    ref = fk.sum_mod(fk.mont_mul(r[:, None, :], preenc), axis=0)
    assert np.array_equal(np.asarray(ref, np.uint32),
                          mxu_lc_numpy(F, preenc, r))


def _mont_rows(rng, rows, width):
    return F.ints_to_mont_limbs(
        [int(v) for v in rng.integers(0, 2 ** 63, rows * width)]
    ).reshape(rows, width, F.num_limbs).astype(np.uint32)


@pytest.mark.parametrize("rows,k", [(129, 32), (2048 + 37, 8)])
def test_mxu_lc_device_matches_spec(rows, k):
    """The jitted int8 combination (the GPU's lc route) equals the numpy
    spec and the Montgomery-product combination, incl. rows > ROWS_MAX
    (chunked partials combined mod p)."""
    import jax

    from ligero_jax.engine.mxu_lc import mxu_lc, mxu_lc_numpy

    rng = np.random.default_rng(rows)
    preenc = _mont_rows(rng, rows, k)
    r = _mont_rows(rng, rows, 1)[:, 0]
    got = np.asarray(jax.jit(lambda p, q: mxu_lc(F, p, q))(preenc, r))
    assert np.array_equal(got, mxu_lc_numpy(F, preenc, r))
    fk = FieldKernel(F, np)
    ref = fk.sum_mod(fk.mont_mul(r[:, None, :], preenc), axis=0)
    assert np.array_equal(got, np.asarray(ref, np.uint32))


def test_split_route_16384_matches_domain_ops():
    """The jitted radix-2 split over two 8192-point four-step leaves
    (odd-branch twiddle folded into the leaf constants) — the 2^20
    commit's n=16384 transform with the canonical epilogue."""
    import jax
    import jax.numpy as jnp

    from ligero_jax.engine.mxu_ntt import ntt_fourstep_any

    n = 16384
    x = _mont_rows(np.random.default_rng(n), 1, n)
    got = np.asarray(jax.jit(lambda a: ntt_fourstep_any(
        FieldKernel(F, jnp), a, n, canon_out=True))(x))
    fk = FieldKernel(F, np)
    assert np.array_equal(got, fk.from_mont(DomainOps(fk, n).fft_padded(x)))


def test_mxu_lc_gate():
    """Only 16-limb fields take the int8 combination."""
    from ligero_jax.engine.mxu_lc import mxu_lc_ok
    from ligero_jax.fields import BLS12_377_FQ

    assert mxu_lc_ok(F) and not mxu_lc_ok(BLS12_377_FQ)


def test_rand_field_elements_u64_reuse_contract():
    """ADVICE r4 #1: the public u64 sampler OWNS its result by default
    (fresh buffer per call); reuse=True opts into the shared cached
    buffer for phase-local consumers."""
    import numpy as np

    from ligero_jax import native
    from ligero_jax.fields import BN254_FR as F
    from ligero_jax.sampling import rand_field_elements_u64

    if not native.available():  # the cache only exists on the native path
        import pytest
        pytest.skip("native kernels unavailable")
    seed_a, seed_b = bytes(range(32)), bytes(range(1, 33))
    a = rand_field_elements_u64(F, 1000, seed_a)
    a_copy = a.copy()
    b = rand_field_elements_u64(F, 1000, seed_b)       # same shape, new draw
    assert not np.shares_memory(a, b)
    assert np.array_equal(a, a_copy)                   # default: no aliasing
    ra = rand_field_elements_u64(F, 1000, seed_a, reuse=True)
    rb = rand_field_elements_u64(F, 1000, seed_b, reuse=True)
    assert np.shares_memory(ra, rb)                    # documented aliasing
    assert np.array_equal(rb, b)
    assert np.array_equal(a, a_copy)                   # defaults unaffected
