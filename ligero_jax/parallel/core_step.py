"""Jittable prover compute cores: single-device and mesh-sharded.

The prover's bulk phase as one jittable step:

    preenc (4m x k)  --iNTT_k/NTT_n-->  U (4m x n)
                     --from-Montgomery, serialize-->
                     --Blake2s columns--> leaves --SHA-256--> Merkle root
    plus the interleaved combination  r^T . preenc  (k)

Sharding design (SURVEY.md §5.8): the **row axis is the data-parallel
axis** — each device Reed–Solomon-encodes its own block of the 4m rows
with zero communication (the NTT never crosses rows).  Column hashing
needs whole columns, so the codeword matrix is re-sharded row->column
with a single ``all_to_all``; each device then hashes its n/D columns
and reduces its local Merkle subtree.  The D subtree roots are
``all_gather``ed (32 bytes each) and the log2(D) top levels are finished
redundantly on every device.  The challenge combination r^T·preenc is a
per-device partial sum whose D partials are gathered and modularly
reduced — the modular sum cannot ride a raw ``psum`` because limb
carries overflow, and at (D, k, L) size the gather is cheaper than a
carry-correct custom reduction.

No collective analogue exists in the reference (it is single-process
rayon; SURVEY.md §2.3) — this distribution scheme is the BASELINE.json
north-star design, not a port.
"""

from __future__ import annotations

import numpy as np

from ..engine.fieldops import FieldKernel
from ..engine.hashops import HashKernel
from ..engine.ntt import DomainOps
from ..fields import FieldSpec


def _byteswap(x):
    return (((x & np.uint32(0xFF)) << np.uint32(24))
            | ((x & np.uint32(0xFF00)) << np.uint32(8))
            | ((x >> np.uint32(8)) & np.uint32(0xFF00))
            | (x >> np.uint32(24)))


def _column_words(xp, u_canon, four_m: int, L: int):
    """Serialize columns of (rows, n, L) canonical limbs into padded
    Blake2s message words; the length prefix always encodes ``four_m``
    (the full column height, even when ``u_canon`` is a row shard)."""
    n = u_canon.shape[1]
    byte_len = 8 + four_m * L * 2
    pad_words = (-(2 + four_m * (L // 2))) % 16
    cols = xp.moveaxis(u_canon, 1, 0)  # (n, rows, L)
    packed = cols[..., 0::2] | (cols[..., 1::2] << np.uint32(16))
    words = packed.reshape(n, -1)
    prefix = np.zeros(2, dtype=np.uint32)
    prefix[0] = four_m & 0xFFFFFFFF
    prefix[1] = four_m >> 32
    pre = xp.broadcast_to(xp.asarray(prefix), (n, 2))
    words = xp.concatenate(
        [pre, words, xp.zeros((n, pad_words), np.uint32)], axis=-1)
    return words, byte_len


def make_prover_core(field: FieldSpec, four_m: int, k: int, n: int):
    """Single-device jittable core.

    Returns ``fn(preenc (4m,k,L) mont, r (4m,L) mont) ->
    (u_canon (4m,n,L) canonical, leaves_le (n,8), root_be (8,), lc (k,L) mont)``.

    Every piece takes the route :class:`Backend` takes on this platform
    (the int8 four-step NTT with the canonical epilogue folded in, the
    Triton column hash and the int8 combination on a GPU; the scan-form
    XLA kernels on the CPU)."""
    from ..engine.backend import Backend

    be = Backend(field, use_jax=True)

    def fn(preenc, r):
        u_canon = be._fft_canon(be._ifft(preenc, k), n)
        leaves_le = be._hash_columns(u_canon)
        level = _byteswap(leaves_le)
        while level.shape[0] > 1:
            level = be.hk.sha256_two_to_one(level[0::2], level[1::2])
        return u_canon, leaves_le, level[0], be._combine(r, preenc)

    return fn


def make_sharded_prover_core(field: FieldSpec, mesh, four_m: int, k: int, n: int,
                             stage: str = "full"):
    """Mesh-sharded prover core over a 1-D device mesh axis ``"rows"``.

    Row blocks of preenc/U are sharded across chips; the commitment phase
    re-shards to columns with an all_to_all.  Returns a function suitable
    for ``jax.jit`` whose inputs/outputs are globally-shaped arrays with
    sharding constraints applied internally via shard_map.

    ``stage`` truncates the pipeline for per-phase attribution
    (scripts/attribute_scaling.py): ``"encode"`` (per-chip RS encode, no
    collectives), ``"encode+a2a"`` (+ the row->column all_to_all),
    ``"encode+a2a+hash"`` (+ column Blake2s + local subtree), ``"full"``
    (+ gathered tree top + challenge combination) — each stage's output
    is materialized so the work cannot be dead-code-eliminated.
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    fk = FieldKernel(field, jnp)
    hk = HashKernel(jnp)
    dom_k = DomainOps(fk, k)
    dom_n = DomainOps(fk, n)
    L = field.num_limbs
    num_devices = mesh.shape["rows"]
    assert four_m % num_devices == 0, "4m must divide the mesh"
    assert n % num_devices == 0, "n must divide the mesh"
    # the pairwise Merkle reductions (local subtree + gathered-roots top)
    # assume power-of-two node counts at every level
    assert num_devices & (num_devices - 1) == 0, \
        "device count must be a power of two"
    assert (n // num_devices) & (n // num_devices - 1) == 0, \
        "per-device leaf count must be a power of two"

    def local_step(preenc_block, r_block):
        # ---- per-device RS encoding of the local row block (no comms)
        coeffs = dom_k.ifft(preenc_block)
        u_evals = dom_n.fft_padded(coeffs)          # (4m/D, n, L)
        u_canon = fk.from_mont(u_evals)             # (canonical; returned)
        if stage == "encode":
            return (u_canon,)

        # ---- row-shard -> column-shard
        # (4m/D, n, L) -> split n into D chunks -> all_to_all -> (4m, n/D, L)
        u_cs = jax.lax.all_to_all(
            u_canon.reshape(four_m // num_devices, num_devices,
                            n // num_devices, L),
            "rows", split_axis=1, concat_axis=0, tiled=False)
        # all_to_all with split/concat: result (D, 4m/D, n/D, L) gathered
        u_cs = u_cs.reshape(four_m, n // num_devices, L)
        if stage == "encode+a2a":
            return (u_canon, u_cs)

        # ---- hash the local columns, reduce the local Merkle subtree
        words, byte_len = _column_words(jnp, u_cs, four_m, L)
        leaves_le = hk.blake2s(words, byte_len)      # (n/D, 8)
        level = _byteswap(leaves_le)
        while level.shape[0] > 1:
            level = hk.sha256_two_to_one(level[0::2], level[1::2])
        subtree_root = level                          # (1, 8)
        if stage == "encode+a2a+hash":
            return (u_canon, leaves_le, subtree_root)

        # ---- finish the top log2(D) levels redundantly on every device
        roots = jax.lax.all_gather(subtree_root[0], "rows")  # (D, 8)
        top = roots
        while top.shape[0] > 1:
            top = hk.sha256_two_to_one(top[0::2], top[1::2])
        root = top[0]

        # ---- challenge-weighted row combination (partial -> gathered sum)
        partial = fk.sum_mod(fk.mont_mul(r_block[:, None, :], preenc_block),
                             axis=0)                  # (k, L), local mod-p sum
        partials = jax.lax.all_gather(partial, "rows")  # (D, k, L)
        lc = fk.sum_mod(partials, axis=0)
        return u_canon, leaves_le, root, lc

    spec_rows = P("rows", None, None)
    spec_cols_leaf = P("rows", None)
    out_specs = {
        "encode": (spec_rows,),
        "encode+a2a": (spec_rows, P(None, "rows", None)),
        "encode+a2a+hash": (spec_rows, spec_cols_leaf, P("rows", None)),
        "full": (spec_rows,          # U row-sharded
                 spec_cols_leaf,     # leaves column-sharded
                 P(),                # root replicated
                 P()),               # lc replicated
    }[stage]
    # scan carries seeded with replicated zeros become device-varying inside
    # the body; skip the varying-manual-axes check rather than pcast every
    # accumulator init
    return shard_map(local_step, mesh=mesh,
                     in_specs=(spec_rows, P("rows", None)),
                     out_specs=out_specs, check_vma=False)
