"""Route choice: made from the platform and the size, never an option.

A GPU gets the int8 four-step NTT, the int8 combination, the spot
evaluation and the Triton column hash; the CPU keeps the scan-form XLA
kernels.  The GPU is simulated by patching the platform probe, so the
routes are traced (not run) here."""

import ast
import os

import pytest

from ligero_jax.fields import BLS12_377_FQ, BN254_FR

F = BN254_FR
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gpu_backend(monkeypatch, field=F):
    from ligero_jax.engine import backend as bmod
    monkeypatch.setattr(bmod, "device_platform", lambda: "gpu")
    return bmod.Backend(field, use_jax=True)


def test_gpu_platform_picks_gpu_routes(monkeypatch):
    import jax
    import jax.numpy as jnp

    be = _gpu_backend(monkeypatch)
    assert be.platform == "gpu" and be.on_gpu
    assert not be.fk.unroll   # scan form: the unrolled compile is 27x longer
    assert all(be._fourstep(n) for n in (1024, 2048, 4096, 8192, 16384,
                                         65536))
    assert not be._fourstep(512) and not be._fourstep(1 << 17)
    assert be._use_mxu_lc() and be._use_mxu_spot(16384, 156)

    # the transform is an s8 x s8 -> s32 dot_general; the hash a
    # pallas_call; the combination an int8 dot
    ntt = str(jax.make_jaxpr(lambda a: be._fft_canon(a, 2048))(
        jnp.zeros((2, 512, 16), jnp.uint32)))
    assert "dot_general" in ntt and "preferred_element_type=int32" in ntt
    leaves = str(jax.make_jaxpr(be._hash_columns)(
        jnp.zeros((4, 256, 16), jnp.uint32)))
    assert "pallas_call" in leaves
    lc = str(jax.make_jaxpr(be._combine)(
        jnp.zeros((8, 16), jnp.uint32), jnp.zeros((8, 32, 16), jnp.uint32)))
    assert "preferred_element_type=int32" in lc


def test_gpu_routes_exclude_wide_fields(monkeypatch):
    be = _gpu_backend(monkeypatch, BLS12_377_FQ)
    assert not be._fourstep(2048) and not be._use_mxu_lc()
    assert not be._use_mxu_spot(2048, 10)


def test_cpu_platform_keeps_scan_form_xla_routes():
    import jax
    import jax.numpy as jnp

    from ligero_jax.engine.backend import Backend

    be = Backend(F, use_jax=True)
    assert be.platform == "cpu" and not be.on_gpu and not be.fk.unroll
    assert not be._fourstep(2048) and not be._use_mxu_lc()
    leaves = str(jax.make_jaxpr(be._hash_columns)(
        jnp.zeros((4, 256, 16), jnp.uint32)))
    assert "pallas_call" not in leaves
    host = Backend(F)
    assert host.platform == "numpy" and not host.on_gpu


def test_unknown_platform_is_an_error(monkeypatch):
    import jax

    from ligero_jax.engine import backend as bmod

    class Dev:
        platform = "metal"
    monkeypatch.setattr(jax, "devices", lambda: [Dev()])
    with pytest.raises(RuntimeError):
        bmod.device_platform()


def _python_files():
    for root in ("ligero_jax", "scripts", "tests"):
        for d, _, files in os.walk(os.path.join(REPO, root)):
            yield from (os.path.join(d, f) for f in files
                        if f.endswith(".py"))
    for f in ("chip_smoke.py", "bench.py", "__graft_entry__.py"):
        yield os.path.join(REPO, f)


def test_only_pallas_backend_imported_is_triton():
    """Every import of a Pallas backend module names Triton's: no module
    reaches a backend whose kernels do not lower for a GPU."""
    prefix = "jax.experimental.pallas."
    backends = set()
    for path in _python_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}"
                                         for a in node.names]
            else:
                continue
            backends |= {(n[len(prefix):].split(".")[0], path)
                         for n in names if n.startswith(prefix)}
    assert {b for b, _ in backends} == {"triton"}, sorted(backends)


def test_jaxcache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache lands there and no
    other directory is set in code (JAX reads the variable itself)."""
    import jax

    from ligero_jax.utils import jaxcache

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.enable() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_entry_size_bytes"] == -1


def test_jaxcache_default_is_one_in_checkout_path(monkeypatch):
    import jax

    from ligero_jax.utils import jaxcache

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jaxcache.enable()
    assert path == os.path.join(REPO, ".jax_cache") == jaxcache.DEFAULT_DIR
    assert calls["jax_compilation_cache_dir"] == path
    assert os.path.isdir(path)
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


def test_resident_budget_is_derived_not_defaulted(monkeypatch):
    """Half of the device's memory; a GPU without memory stats is an
    error, not a default; the env override wins."""
    import jax

    from ligero_jax.ligero import core

    class Gpu:
        platform = "gpu"

        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    monkeypatch.delenv("LIGERO_RESIDENT_BUDGET_GB", raising=False)
    monkeypatch.setattr(jax, "devices",
                        lambda: [Gpu({"bytes_limit": 60 << 30})])
    assert core._resident_budget() == 30 << 30
    monkeypatch.setattr(jax, "devices", lambda: [Gpu(None)])
    with pytest.raises(RuntimeError):
        core._resident_budget()
    monkeypatch.setenv("LIGERO_RESIDENT_BUDGET_GB", "2")
    assert core._resident_budget() == 2 << 30
