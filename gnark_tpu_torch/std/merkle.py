"""Merkle proof verification gadget.

Reference: std/accumulator/merkle (VerifyProof over a hash gadget;
leaves hashed with the same hash, path bits select sibling order).
"""

from __future__ import annotations

from gnark_tpu_torch.std.hash.mimc import MiMC, MiMCGadget


def verify_proof(api, root, leaf, path, directions,
                 field_name: str = "bn254_fr") -> None:
    """Assert that `leaf` at the position encoded by `directions`
    (LSB-first booleans: 0 = current node is left child) hashes up
    through `path` (sibling digests, bottom-up) to `root`."""
    cur = leaf
    for sib, d in zip(path, directions):
        api.assert_is_boolean(d)
        left = api.select(d, sib, cur)
        right = api.select(d, cur, sib)
        h = MiMCGadget(api, field_name)
        h.write(left, right)
        cur = h.sum()
    api.assert_is_equal(cur, root)


def host_merkle_root(leaves, field_name: str = "bn254_fr"):
    """Host-side Merkle tree; returns (root, proof_fn).

    proof_fn(i) -> (path, directions) for leaf i."""
    assert leaves and (len(leaves) & (len(leaves) - 1)) == 0, \
        "power-of-two leaf count"
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        prev = levels[-1]
        nxt = []
        for i in range(0, len(prev), 2):
            nxt.append(MiMC(field_name).write(prev[i], prev[i + 1]).sum())
        levels.append(nxt)
    root = levels[-1][0]

    def proof(i: int):
        path, dirs = [], []
        idx = i
        for lvl in levels[:-1]:
            sib = idx ^ 1
            path.append(lvl[sib])
            dirs.append(idx & 1)   # 1 => current node is right child
            idx >>= 1
        return path, dirs

    return root, proof
