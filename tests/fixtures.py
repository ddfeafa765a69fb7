"""Shared circuit/expression fixture generators, mirroring the reference
test generators (/root/reference/src/arithmetic_circuit/tests.rs:17-105 and
/root/reference/src/expression/tests.rs:13-60)."""

import os

from ligero_jax.circuit import ArithmeticCircuit, Expression
from ligero_jax.fields import BLS12_377_FQ, BN254_FR

REFERENCE_CIRCOM = os.environ.get("LIGERO_REFERENCE_CIRCOM",
                                  "/root/reference/circom")


def generate_bls12_377_circuit() -> ArithmeticCircuit:
    """y^2 = x^3 + 1 over BLS12-377 Fq; proves x^3 + 1 - y^2 + 1 = 1."""
    c = ArithmeticCircuit(BLS12_377_FQ)
    one = c.constant(1)
    x = c.new_variable_with_label("x")
    y = c.new_variable_with_label("y")
    y_sq = c.pow(y, 2)
    minus_y_sq = c.minus(y_sq)
    x_cubed = c.pow(x, 3)
    c.add_nodes([x_cubed, one, minus_y_sq, one])
    return c


def generate_bls12_377_expression() -> Expression:
    x = Expression.variable("x", BLS12_377_FQ)
    y = Expression.variable("y", BLS12_377_FQ)
    return 1 + (1 + x.pow(3) - y.pow(2))


def generate_lemniscate_circuit() -> ArithmeticCircuit:
    """(x^2 + y^2)^2 - 120x^2 + 80y^2 + 1 = 1 over BN254 Fr."""
    c = ArithmeticCircuit(BN254_FR)
    one = c.constant(1)
    x = c.new_variable()
    y = c.new_variable()
    a = c.constant(120)
    b = c.constant(80)
    x2 = c.mul(x, x)
    y2 = c.mul(y, y)
    ax2 = c.mul(a, x2)
    by2 = c.mul(b, y2)
    m_ax2 = c.minus(ax2)
    s = c.add(x2, y2)
    t = c.add(by2, m_ax2)
    sq = c.mul(s, s)
    c.add_nodes([sq, t, one])
    return c


def generate_lemniscate_expression() -> Expression:
    x = Expression.variable("x", BN254_FR)
    y = Expression.variable("y", BN254_FR)
    return 1 + (x.pow(2) + y.pow(2)).pow(2) - 120 * x.pow(2) + 80 * y.pow(2)


def generate_3_by_3_determinant_circuit() -> ArithmeticCircuit:
    c = ArithmeticCircuit(BN254_FR)
    one = c.constant(1)
    vars_ = c.new_variables(9)
    det = c.new_variable()
    aei = c.mul_nodes([vars_[0], vars_[4], vars_[8]])
    bfg = c.mul_nodes([vars_[1], vars_[5], vars_[6]])
    cdh = c.mul_nodes([vars_[2], vars_[3], vars_[7]])
    ceg = c.mul_nodes([vars_[2], vars_[4], vars_[6]])
    bdi = c.mul_nodes([vars_[1], vars_[3], vars_[8]])
    afh = c.mul_nodes([vars_[0], vars_[5], vars_[7]])
    s1 = c.add_nodes([aei, bfg, cdh])
    s2 = c.add_nodes([ceg, bdi, afh])
    m2 = c.minus(s2)
    md = c.minus(det)
    c.add_nodes([s1, m2, md, one])
    return c


def generate_3_by_3_determinant_expression() -> Expression:
    matrix = [[Expression.variable(f"x_{i}_{j}", BN254_FR) for j in range(3)]
              for i in range(3)]
    positive = Expression.sum([
        Expression.product([matrix[i][(j + k) % 3] for j, i in zip([0, 4, 8], range(3))])
        for k in range(3)])
    negative = Expression.sum([
        Expression.product([matrix[i][(j + k) % 3] for j, i in zip([2, 4, 6], range(3))])
        for k in range(3)])
    det = Expression.variable("det", BN254_FR)
    return 1 + (positive - negative - det)
