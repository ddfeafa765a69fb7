import hashlib

from ligero_jax.fields import BN254_FR
from ligero_jax.hashes import column_hash, serialize_field_vec, sha256_compress
from ligero_jax.merkle import MerklePath, MerkleTree, create_merkle_tree


def test_serialize_field_vec():
    got = serialize_field_vec(BN254_FR, [1, 2])
    assert got[:8] == (2).to_bytes(8, "little")
    assert got[8:40] == (1).to_bytes(32, "little")
    assert got[40:] == (2).to_bytes(32, "little")
    assert column_hash(BN254_FR, [1, 2]) == hashlib.blake2s(got).digest()


def test_merkle_roundtrip():
    leaves = [hashlib.blake2s(bytes([i])).digest() for i in range(8)]
    tree = MerkleTree(leaves)
    # manual root
    l1 = [sha256_compress(leaves[2 * i], leaves[2 * i + 1]) for i in range(4)]
    l2 = [sha256_compress(l1[0], l1[1]), sha256_compress(l1[2], l1[3])]
    root = sha256_compress(l2[0], l2[1])
    assert tree.root == root

    for i in range(8):
        path = tree.generate_proof(i)
        assert path.leaf_index == i
        assert len(path.auth_path) == 2
        assert path.verify(root, leaves[i])
        assert not path.verify(root, leaves[(i + 1) % 8])

    # tampered sibling fails
    p = tree.generate_proof(3)
    bad = MerklePath(p.leaf_index, b"\x00" * 32, p.auth_path)
    assert not bad.verify(root, leaves[3])


def test_create_merkle_tree_padding():
    leaves = [bytes([i]) * 32 for i in range(5)]
    tree = create_merkle_tree(leaves)
    assert len(tree.leaves) == 8
    assert tree.leaves[5:] == [b"", b"", b""]
    assert tree.generate_proof(4).verify(tree.root, leaves[4])


def test_digest_lists_matches_per_level_path():
    """Backend._digest_lists (one fused device transfer + vectorized
    packing) must equal the per-level _tree_levels download path byte
    for byte, for every tree size class incl. the n=1 no-inner edge."""
    import numpy as np
    from ligero_jax.engine.backend import Backend
    from ligero_jax.engine.hashops import be_words_to_bytes, words_to_le_bytes
    from ligero_jax.fields import BN254_FR

    for use_jax in (False, True):
        be = Backend(BN254_FR, use_jax=use_jax)
        rng = np.random.default_rng(5)
        for n in (1, 2, 8, 64):
            leaves_le = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
            got_leaves, got_inner = be._digest_lists(leaves_le)
            levels = be._tree_levels(leaves_le)
            assert got_leaves == [words_to_le_bytes(r) for r in leaves_le]
            assert got_inner == [[be_words_to_bytes(r)
                                  for r in be.to_numpy(lv)] for lv in levels]
