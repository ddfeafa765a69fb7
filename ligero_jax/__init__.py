"""ligero-jax: a Ligero SNARK framework in JAX (GPU device path + C++ host).

Public API surface:

    from ligero_jax import (BN254_FR, BLS12_377_FQ, ArithmeticCircuit,
                            Expression, LigeroCircuit, LigeroProof,
                            test_sponge)
"""

from .fields import BLS12_377_FQ, BN254_FR, FIELDS, FieldSpec

if __import__("os").environ.get("LIGERO_MALLOC_TUNE") != "0":
    # keep gigabyte allocations on the reused brk heap (native.tune_malloc
    # — first-touch page faults dominate fresh big buffers on some
    # hosts; its effect on the GPU machine is unmeasured, ROADMAP 3.2).
    # Costs RSS (freed blocks stay mapped); LIGERO_MALLOC_TUNE=0 restores
    # glibc defaults.
    from . import native as _native
    _native.tune_malloc()

__version__ = "0.1.0"

__all__ = [
    "BN254_FR", "BLS12_377_FQ", "FIELDS", "FieldSpec",
    "ArithmeticCircuit", "Expression", "LigeroCircuit", "LigeroProof",
    "test_sponge",
]


def __getattr__(name):
    # lazy imports keep `import ligero_jax` light (no jax/ctypes at import)
    if name in ("ArithmeticCircuit", "Expression"):
        from . import circuit
        return getattr(circuit, name)
    if name in ("LigeroCircuit", "LigeroProof"):
        from . import ligero
        return getattr(ligero, name)
    if name == "test_sponge":
        from .sponge import test_sponge
        return test_sponge
    raise AttributeError(name)
