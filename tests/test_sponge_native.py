"""Native (C++) Poseidon absorb vs the Python duplex state machine.

The C++ path (native/ligero_host.cpp lh_poseidon_absorb) must be
bit-exact through every mode transition: fresh sponge, mid-absorb
position, post-squeeze re-absorb, multi-permute long inputs."""

import numpy as np
import pytest

from ligero_jax import native
from ligero_jax.fields import BLS12_377_FQ, BN254_FR
from ligero_jax.sponge import PoseidonSponge, test_sponge

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native kernels unavailable")


def _python_only(sp: PoseidonSponge) -> PoseidonSponge:
    c = sp.clone()
    c.NATIVE_ABSORB_THRESHOLD = 1 << 60  # force the Python machine
    return c


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ])
@pytest.mark.parametrize("length", [16, 17, 31, 100, 1024])
def test_native_absorb_matches_python(field, length):
    rng = np.random.default_rng(length)
    elems = [int(x) for x in rng.integers(0, 2 ** 63, length)]
    sp_native = test_sponge(field)
    sp_py = _python_only(sp_native)
    sp_native.absorb_field_elems(elems)
    sp_py.absorb_field_elems(elems)
    assert sp_native.state == sp_py.state
    assert (sp_native.mode, sp_native.mode_index) == (sp_py.mode, sp_py.mode_index)
    assert sp_native.squeeze_bytes(32) == sp_py.squeeze_bytes(32)


def test_native_absorb_all_mode_transitions():
    field = BN254_FR
    sp_native = test_sponge(field)
    sp_py = _python_only(sp_native)
    for sp in (sp_native, sp_py):
        sp.absorb_field_elems([7])            # mid-absorb position 1
        sp.absorb_field_elems(list(range(20)))  # long absorb from position 1
        sp.squeeze_bytes(32)                  # switch to squeezing
        sp.absorb_field_elems(list(range(33)))  # re-absorb after squeeze
        sp.absorb_bytes(b"root" * 8)          # byte framing path
    assert sp_native.state == sp_py.state
    assert sp_native.squeeze_bytes(64) == sp_py.squeeze_bytes(64)


def test_native_absorb_transcript_pin():
    """The poseidon-fixture transcript shape: absorb 32B root, squeeze,
    absorb k=128 elems, squeeze — native == python at every step."""
    field = BN254_FR
    sp_native = test_sponge(field)
    sp_py = _python_only(sp_native)
    rng = np.random.default_rng(0)
    lc = [int(x) % field.p for x in rng.integers(0, 2 ** 63, 128)]
    for sp in (sp_native, sp_py):
        sp.absorb_bytes(bytes(range(32)))
        sp.squeeze_bytes(32)
        sp.absorb_field_elems(lc)
    assert sp_native.squeeze_bytes(32) == sp_py.squeeze_bytes(32)
