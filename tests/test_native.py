import random

import numpy as np
import pytest

from ligero_jax import native
from ligero_jax.fields import BLS12_377_FQ, BN254_FR

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native kernels unavailable")


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
def test_mont_roundtrip_and_limb_conversions(field):
    rng = random.Random(1)
    vals = [rng.randrange(field.p) for _ in range(40)] + [0, 1, field.p - 1]
    u64 = native.ints_to_u64_limbs(vals, field.num_u64_limbs)
    native.to_mont_inplace(field, u64)
    expect_mont = [field.to_mont(v) for v in vals]
    got = [int.from_bytes(u64[i].tobytes(), "little") for i in range(len(vals))]
    assert got == expect_mont
    # u64 <-> u16 limb reshuffles
    u16 = native.u64_to_u16_limbs(u64, field.num_limbs)
    assert field.limbs_to_ints(u16) == expect_mont
    assert np.array_equal(native.u16_to_u64_limbs(u16), u64)
    native.from_mont_inplace(field, u64)
    got = [int.from_bytes(u64[i].tobytes(), "little") for i in range(len(vals))]
    assert got == vals


def test_eval_circuit_matches_python():
    from fixtures import generate_lemniscate_circuit
    F = BN254_FR
    c = generate_lemniscate_circuit()
    vars_ = [(1, 8), (2, 4)]
    trace = c.evaluation_trace_multioutput(vars_, [c.last()])

    n = c.num_nodes()
    kinds = np.zeros(n, dtype=np.uint8)
    lefts = np.zeros(n, dtype=np.int64)
    rights = np.zeros(n, dtype=np.int64)
    have = np.zeros(n, dtype=np.uint8)
    preset = []
    for i, node in enumerate(c.nodes):
        if node[0] == "add":
            kinds[i], lefts[i], rights[i] = 1, node[1], node[2]
        elif node[0] == "mul":
            kinds[i], lefts[i], rights[i] = 2, node[1], node[2]
        else:
            have[i] = 1
            preset.append((i, node[1] if node[0] == "const" else dict(vars_)[i]))
    vals = np.zeros((n, F.num_u64_limbs), dtype=np.uint64)
    pre = native.ints_to_u64_limbs([F.to_mont(v) for _, v in preset],
                                   F.num_u64_limbs)
    for (i, _), row in zip(preset, pre):
        vals[i] = row
    native.eval_circuit_mont(F, kinds, lefts, rights, vals, have)
    native.from_mont_inplace(F, vals)
    got = [int.from_bytes(vals[i].tobytes(), "little") for i in range(n)]
    assert got == trace


def test_sparse_row_mul_matches_python():
    from ligero_jax.matrices import SparseMatrix
    F = BN254_FR
    rng = random.Random(5)
    num_rows, num_cols = 20, 15
    mat = SparseMatrix(F, num_cols)
    for _ in range(num_rows):
        mat.push_row([(rng.randrange(F.p), rng.randrange(num_cols))
                      for _ in range(rng.randrange(4))])
    r = [rng.randrange(F.p) for _ in range(num_rows)]
    expect = mat.row_mul(r)

    rows, cols, vals = mat.to_coo()
    vals_u64 = native.ints_to_u64_limbs([F.to_mont(v) for v in vals],
                                        F.num_u64_limbs)
    r_u64 = native.ints_to_u64_limbs([F.to_mont(v) for v in r],
                                     F.num_u64_limbs)
    out = native.sparse_row_mul_mont(F, rows, cols, vals_u64, r_u64, num_cols)
    # mont_mul(rR, vR) = (rv)R, so `out` is the Montgomery form of the sum
    native.from_mont_inplace(F, out)
    got = [int.from_bytes(out[i].tobytes(), "little") for i in range(num_cols)]
    assert got == expect


def test_mul_sum_rows_matches_host_kernel():
    import numpy as np
    from ligero_jax import native
    from ligero_jax.engine.fieldops import FieldKernel
    from ligero_jax.fields import BN254_FR as F
    from ligero_jax.sampling import rand_field_elements_limbs
    if not native.available():
        import pytest
        pytest.skip("native lib not built")
    rows, t = 37, 11
    a = rand_field_elements_limbs(F, rows * t, b"\x03" * 32).reshape(rows, t, -1)
    b = rand_field_elements_limbs(F, rows * t, b"\x04" * 32).reshape(rows, t, -1)
    fk = FieldKernel(F, np)
    want = F.limbs_to_ints(fk.sum_mod(fk.mont_mul(a, b), axis=0))
    a64 = native.u16_to_u64_limbs(a.reshape(rows * t, -1)).reshape(rows, t, -1)
    b64 = native.u16_to_u64_limbs(b.reshape(rows * t, -1)).reshape(rows, t, -1)
    got = F.limbs_to_ints(
        native.u64_to_u16_limbs(native.mul_sum_rows_mont(F, a64, b64), F.num_limbs))
    assert got == want


def test_quad_spot_matches_host_kernel():
    import numpy as np
    from ligero_jax import native
    from ligero_jax.engine.fieldops import FieldKernel
    from ligero_jax.fields import BN254_FR as F
    from ligero_jax.sampling import rand_field_elements_limbs
    if not native.available():
        import pytest
        pytest.skip("native lib not built")
    rows, t = 23, 9
    rng = np.random.default_rng(5)
    xyz = [F.ints_to_limbs([int(v) % F.p for v in rng.integers(0, 1 << 63, rows * t)])
           .reshape(rows, t, -1) for _ in range(3)]
    x, y, z = xyz
    r = rand_field_elements_limbs(F, rows, b"\x06" * 32)
    fk = FieldKernel(F, np)
    term = fk.sub(fk.mont_mul(fk.to_mont(x), y), z)
    want = F.limbs_to_ints(fk.sum_mod(fk.mont_mul(r[:, None, :], term), axis=0))

    def to64(a):
        return native.u16_to_u64_limbs(a.reshape(rows * t, -1)).reshape(rows, t, -1)

    out = native.quad_spot_mont(F, to64(x), to64(y), to64(z),
                                native.u16_to_u64_limbs(r))
    got = F.limbs_to_ints(native.u64_to_u16_limbs(out, F.num_limbs))
    assert got == want


def test_sparse_row_mul_sorted_parallel_bitexact():
    """The column-partitioned OpenMP kernel (col_sorted=True, requires a
    stable column sort) must produce bit-identical sums to the serial
    row-order kernel: mod-p accumulation is exact, and the stable sort
    preserves per-column entry order."""
    rng = np.random.default_rng(11)
    F = BN254_FR
    for nnz, ncols, nrows in [(1, 1, 1), (1000, 64, 128),
                              (100000, 4096, 8192)]:
        rows = rng.integers(0, nrows, nnz).astype(np.int32)
        cols = rng.integers(0, ncols, nnz).astype(np.int32)
        vals = rng.integers(0, 2**62, (nnz, 4)).astype(np.uint64)
        r = rng.integers(0, 2**62, (nrows, 4)).astype(np.uint64)
        a = native.sparse_row_mul_mont(F, rows, cols, vals, r, ncols)
        order = np.argsort(cols, kind="stable")
        b = native.sparse_row_mul_mont(
            F, np.ascontiguousarray(rows[order]),
            np.ascontiguousarray(cols[order]),
            np.ascontiguousarray(vals[order]), r, ncols, col_sorted=True)
        assert np.array_equal(a, b), nnz
