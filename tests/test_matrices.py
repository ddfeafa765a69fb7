"""Matrix tests mirroring /root/reference/src/matrices/mod.rs:174-208."""

from ligero_jax.fields import BN254_FR
from ligero_jax.matrices import DenseMatrix, SparseMatrix

F = BN254_FR


def test_mat_mul_dense():
    m = DenseMatrix(F, [[1, 2, 8], [3, 4, 5]])
    v = [(-5) % F.p, 17]
    assert m.row_mul(v) == [46, 58, 45]


def test_mat_mul_sparse():
    m = SparseMatrix(F, 3)
    m.push_row([(1, 0), (8, 2)])
    m.push_row([(4, 1), (5, 2)])
    v = [(-5) % F.p, 17]
    assert m.row_mul(v) == [(-5) % F.p, 68, 45]


def test_stacking_and_neg():
    i2 = SparseMatrix.identity(F, 2)
    z = SparseMatrix.zero(F, 2, 3)
    h = i2.h_stack(z)
    assert h.num_cols == 5 and h.rows == [[(1, 0)], [(1, 1)]]
    v = i2.v_stack(SparseMatrix.identity(F, 2))
    assert v.num_rows() == 4
    n = -i2
    assert n.rows == [[(F.p - 1, 0)], [(F.p - 1, 1)]]


def test_dense_columns():
    m = DenseMatrix(F, [[1, 2], [3, 4]])
    assert m.columns() == [[1, 3], [2, 4]]
    assert m.column(1) == [2, 4]
    assert m.num_columns() == 2
