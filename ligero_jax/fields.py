"""Prime-field specifications for the Ligero framework.

Design
------
Field elements live in one of two representations:

* **host scalars** — canonical Python ints in ``[0, p)``; used by the
  transcript (Poseidon sponge), circuit evaluation and sparse host algebra.
* **device limb arrays** — ``uint32`` arrays of shape ``(..., L)`` holding
  ``L`` little-endian 16-bit limbs (each limb ``< 2**16``), normally in
  *Montgomery form* (``x_mont = x * R mod p`` with ``R = 2**(16 * L)``).
  16-bit limbs are chosen so that limb products fit comfortably in
  32-bit integer lanes (the device path uses no 64-bit integers).

``R`` matches the arkworks 64-bit-limb Montgomery radix (``2**256`` for
BN254 Fr, ``2**384`` for BLS12-377 Fq), so Montgomery representations are
bit-identical with the reference implementation's internal state.  That is
what makes the challenge streams reproducible: ``F::rand`` in ark-ff
(ark_ff::UniformRand, used by /root/reference/src/utils.rs:23-29) treats
freshly sampled limbs as the *Montgomery* representation.

Field constants were derived and verified numerically:

* BN254 Fr: smallest multiplicative generator is 5 (verified against the
  full factorisation of r-1); TWO_ADIC_ROOT_OF_UNITY =
  5^((r-1)/2^28) mod r, matching the ark-bn254 constant.
* BLS12-377 Fq: generator 15 reproduces the ark-bls12-377
  TWO_ADIC_ROOT_OF_UNITY constant (order 2^46 verified).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class FieldSpec:
    """Immutable description of a prime field and its limb decomposition."""

    name: str
    p: int
    generator: int          # smallest multiplicative generator (ark convention)
    two_adicity: int

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------
    @property
    def modulus_bit_size(self) -> int:
        return self.p.bit_length()

    @property
    def num_u64_limbs(self) -> int:
        """Number of 64-bit limbs ark-ff uses for this modulus."""
        return (self.modulus_bit_size + 63) // 64

    @property
    def num_limbs(self) -> int:
        """Number of 16-bit device limbs (R has the same width as ark's)."""
        return self.num_u64_limbs * 4

    @property
    def r_bits(self) -> int:
        return self.num_limbs * LIMB_BITS

    @functools.cached_property
    def R(self) -> int:  # noqa: N802 — Montgomery radix, ark naming
        return (1 << self.r_bits) % self.p

    @functools.cached_property
    def R2(self) -> int:  # noqa: N802
        return (1 << (2 * self.r_bits)) % self.p

    @functools.cached_property
    def R_inv(self) -> int:  # noqa: N802
        return pow(1 << self.r_bits, -1, self.p)

    @functools.cached_property
    def n16(self) -> int:
        """-p^{-1} mod 2^16 — the Montgomery multiplier for 16-bit REDC."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def two_adic_root(self) -> int:
        """g^((p-1)/2^s) mod p — ark's TWO_ADIC_ROOT_OF_UNITY."""
        return pow(self.generator, (self.p - 1) >> self.two_adicity, self.p)

    @property
    def serialized_size(self) -> int:
        """Bytes of the canonical ark-serialize compressed encoding."""
        return (self.modulus_bit_size + 7) // 8

    @property
    def sponge_usable_bytes(self) -> int:
        """Usable bytes per element for squeeze_bytes (ark sponge rule)."""
        return (self.modulus_bit_size - 1) // 8

    # ------------------------------------------------------------------
    # Scalar limb conversions (host)
    # ------------------------------------------------------------------
    def int_to_limbs(self, x: int) -> np.ndarray:
        out = np.empty(self.num_limbs, dtype=np.uint32)
        for i in range(self.num_limbs):
            out[i] = x & LIMB_MASK
            x >>= LIMB_BITS
        return out

    def limbs_to_int(self, limbs) -> int:
        x = 0
        for i in reversed(range(self.num_limbs)):
            x = (x << LIMB_BITS) | int(limbs[..., i] if limbs.ndim > 1 else limbs[i])
        return x

    # Vectorised conversions -------------------------------------------------
    def ints_to_limbs(self, xs) -> np.ndarray:
        """list[int] -> (N, L) uint32 little-endian 16-bit limbs."""
        nbytes = self.num_limbs * 2
        try:
            from . import native
        except ImportError:
            native = None
        if native is not None and native.pylong_available():
            buf = native.le_bytes_from_longs(
                xs if isinstance(xs, (list, tuple)) else list(xs), nbytes)
        else:
            buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
        u16 = np.frombuffer(buf, dtype="<u2").reshape(len(xs), self.num_limbs)
        return u16.astype(np.uint32)

    def limbs_to_ints(self, limbs: np.ndarray) -> list[int]:
        """(N, L) uint32 -> list[int]."""
        limbs = np.ascontiguousarray(limbs.astype("<u2"))
        n = limbs.shape[0]
        sz = self.num_limbs * 2
        try:  # native batch PyLong construction (~10x the from_bytes loop)
            from . import native
            if native.pylong_available():
                return native.longs_from_le_bytes(limbs, n, sz)
        except ImportError:
            pass
        raw = limbs.tobytes()
        return [int.from_bytes(raw[i * sz:(i + 1) * sz], "little") for i in range(n)]

    # Montgomery helpers (host scalars) --------------------------------------
    def to_mont(self, x: int) -> int:
        return (x * self.R) % self.p

    def from_mont(self, x: int) -> int:
        return (x * self.R_inv) % self.p

    def ints_to_mont_limbs(self, xs) -> np.ndarray:
        try:  # native CIOS batch conversion (~50x the per-int Python mulmod)
            from . import native
            if native.available():
                u64 = native.ints_to_u64_limbs([int(x) % self.p for x in xs],
                                               self.num_u64_limbs)
                native.to_mont_inplace(self, u64)
                return native.u64_to_u16_limbs(u64, self.num_limbs)
        except ImportError:
            pass
        return self.ints_to_limbs([(int(x) * self.R) % self.p for x in xs])

    def mont_limbs_to_ints(self, limbs: np.ndarray) -> list[int]:
        try:
            from . import native
            if native.available():
                u64 = native.u16_to_u64_limbs(
                    np.ascontiguousarray(limbs).reshape(-1, self.num_limbs))
                native.from_mont_inplace(self, u64)
                sz = self.num_u64_limbs * 8
                u64 = np.ascontiguousarray(u64)
                if native.pylong_available():
                    # LSB-first u64 limbs ARE the little-endian byte layout
                    return native.longs_from_le_bytes(u64.view("<u8"),
                                                      u64.shape[0], sz)
                raw = u64.tobytes()
                return [int.from_bytes(raw[i * sz:(i + 1) * sz], "little")
                        for i in range(u64.shape[0])]
        except ImportError:
            pass
        return [(v * self.R_inv) % self.p for v in self.limbs_to_ints(limbs)]

    # Constant limb tables used by the device kernels ------------------------
    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return self.int_to_limbs(self.p)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return self.int_to_limbs(self.R2)

    @functools.cached_property
    def one_mont_limbs(self) -> np.ndarray:
        return self.int_to_limbs(self.R)

    def root_of_unity(self, n: int) -> int:
        """Domain generator for a radix-2 domain of size n (ark convention).

        ark_poly Radix2EvaluationDomain::new(n):
        omega = TWO_ADIC_ROOT_OF_UNITY ^ (2^(two_adicity - log2(n))).
        """
        assert n & (n - 1) == 0 and n > 0
        log_n = n.bit_length() - 1
        assert log_n <= self.two_adicity, f"domain size {n} too large"
        return pow(self.two_adic_root, 1 << (self.two_adicity - log_n), self.p)


# ---------------------------------------------------------------------------
# Concrete fields used by the reference test-suite
# ---------------------------------------------------------------------------

#: BN254 (alt_bn128) scalar field — the circom/arkworks workhorse.
BN254_FR = FieldSpec(
    name="bn254_fr",
    p=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
    two_adicity=28,
)

#: BLS12-377 *base* field Fq (two-adicity 46) — used by the curve-equation
#: fixture circuits in the reference (reference src/arithmetic_circuit/tests.rs:17).
BLS12_377_FQ = FieldSpec(
    name="bls12_377_fq",
    p=0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    generator=15,
    two_adicity=46,
)

FIELDS = {f.name: f for f in (BN254_FR, BLS12_377_FQ)}

# Sanity pins (checked at import time; both were verified against ark constants)
assert BN254_FR.two_adic_root == 19103219067921713944291392827692070036145651957329286315305642004821462161904
assert BLS12_377_FQ.two_adic_root == 32863578547254505029601261939868325669770508939375122462904745766352256812585773382134936404344547323199885654433
assert BN254_FR.num_limbs == 16 and BLS12_377_FQ.num_limbs == 24
