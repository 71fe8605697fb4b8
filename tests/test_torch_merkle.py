"""The port's Merkle tree and pair hash (K2: bitcoincashplus_tpu_torch/ops/
merkle.py, csrc/sha256d_batch.cu), the device leg of ops/dispatch.
merkle_root, CheckBlock's Merkle rules and the certificate MMR, on the CPU
device — the plain PyTorch versions stand in for the CUDA kernels —
against the JAX package and the oracles it is tested against
(consensus/merkle.compute_merkle_root and merkle_root_naive, hashlib).

Tolerance: exact equality everywhere (integer hashing, boolean flags).

Cost: the JAX tree and pair programs run eagerly under jax.disable_jit()
(their jit is minutes of XLA compile on a CPU): one 128-leaf bucket, about
15 s, and 128 pair rows. Everything else is held against the oracles.

The tree kernel's schedule (blocks of up to 8 levels over subtrees, the
whole tree's live count in every block, dead pairs skipped; up to 16
levels one launch, in which each block writes its root and `mutated`
word and takes a ticket, and the block that draws the last ticket reduces
the levels above; deeper trees chain launches of 8 levels) has a model
here, ``model_merkle_tree``, written after csrc/sha256d_batch.cu's loops:
run with fewer levels a block, it takes the two-stage and the chained
paths at small sizes; its blocks run in a seeded shuffled order (the
card's blocks run in none); slots a launch leaves unwritten hold a poison
value (a `mutated` word an unwritten marker that raises when read), so a
live node that read one would show.
"""

import dataclasses
import hashlib
import json
import os
import random
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoincashplus_tpu.ops import merkle as jmerkle
from bitcoincashplus_tpu_torch.consensus import merkle as cmerkle
from bitcoincashplus_tpu_torch.consensus.block import CBlock, CBlockHeader
from bitcoincashplus_tpu_torch.consensus.params import regtest_params
from bitcoincashplus_tpu_torch.consensus.tx import (COutPoint, CTransaction,
                                                    CTxIn, CTxOut)
from bitcoincashplus_tpu_torch.ops import cuda_build, dispatch
from bitcoincashplus_tpu_torch.ops import merkle as M
from bitcoincashplus_tpu_torch.ops.cuda_build import KernelUnavailable
from bitcoincashplus_tpu_torch.store import certificate
from bitcoincashplus_tpu_torch.store.blockstore import MemoryBlockStore
from bitcoincashplus_tpu_torch.util import faults
from bitcoincashplus_tpu_torch.validation.chainstate import (
    BlockValidationError, ChainstateManager)
from bitcoincashplus_tpu_torch.validation.coins import MemoryCoinsView

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    for k in [k for k in os.environ if k.startswith("BCP_FAULT")]:
        monkeypatch.delenv(k)
    monkeypatch.delenv("BCP_TPU_MERKLE_MIN", raising=False)
    faults.INJECTOR.reload()
    dispatch.reset()
    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    cuda_build.set_device("cpu")
    yield
    faults.INJECTOR.reload()
    dispatch.reset()


def sha256d(b: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(b).digest()).digest()


def leaves(n: int, tag: str = "leaf") -> list:
    return [hashlib.sha256(f"{tag}:{n}:{i}".encode()).digest()
            for i in range(n)]


def bucket_words(hashes: list, bucket: int) -> torch.Tensor:
    words = M._digests_to_words(
        np.frombuffer(b"".join(hashes), np.uint8).reshape(-1, 32))
    words = np.concatenate(
        [words, np.zeros((bucket - len(hashes), 8), np.uint32)])
    return torch.from_numpy(words.view(np.int32))


def digest(words) -> bytes:
    return struct.pack(">8I", *(int(w) & 0xFFFFFFFF for w in words))


class Counter:
    """Wraps a module attribute and records each call's first argument."""

    def __init__(self, monkeypatch, obj, name):
        self.calls = []
        real = getattr(obj, name)

        def wrapped(*a, **k):
            self.calls.append(a[0] if a else None)
            return real(*a, **k)

        monkeypatch.setattr(obj, name, wrapped)


# ---- the plain tree against the JAX program --------------------------------

def test_plain_tree_equals_the_jax_program_on_a_128_leaf_bucket():
    hs = leaves(77)
    words = bucket_words(hs, 128)
    with jax.disable_jit():
        root, mutated, witness = jmerkle._tree_reduce_jit(
            jnp.asarray(words.numpy().view(np.uint32)), 7, jnp.uint32(77))
    got = M.merkle_tree(words, 7, 77)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(root))
    assert bool(got[1]) is bool(mutated) is False
    np.testing.assert_array_equal(got[2].numpy().view(np.uint32),
                                  np.asarray(witness))
    assert digest(got[0]) == cmerkle.compute_merkle_root(hs)[0]
    assert digest(got[2]) == sha256d(hs[0] + hs[1])


@pytest.mark.parametrize("n", [2, 3, 77, 128, 511, 512, 513, 1000, 4097])
def test_tree_equals_the_oracles(n):
    hs = leaves(n)
    root, mutated, used = M.compute_merkle_root_tpu_ex(hs)
    assert used
    assert (root, mutated) == cmerkle.compute_merkle_root(hs)
    assert root == cmerkle.merkle_root_naive(hs)
    assert not mutated


def test_mutation_flags():
    # a duplicated tail: 301 leaves and a copy of the last is mutated and
    # keeps the root (CVE-2012-2459)
    hs = leaves(301)
    dup = hs + [hs[-1]]
    r_dup = M.compute_merkle_root_tpu_ex(dup)
    assert r_dup[:2] == (cmerkle.compute_merkle_root(hs)[0], True)
    # the same one level up: the last 2 leaves of 302 repeated
    hs2 = leaves(302)
    r2 = M.compute_merkle_root_tpu_ex(hs2 + hs2[-2:])
    assert r2[:2] == (cmerkle.compute_merkle_root(hs2)[0], True)
    # the legitimate self-paired tail is not mutated
    assert M.compute_merkle_root_tpu_ex(hs)[1] is False
    # equal pairs past the live count are not mutated
    words = bucket_words(hs, 512)
    words[301:] = words[300]
    root, mutated, witness = M.merkle_tree(words, 9, 301)
    assert not bool(mutated)
    assert digest(root) == cmerkle.compute_merkle_root(hs)[0]
    assert digest(witness) == sha256d(hs[0] + hs[1])
    # a live equal pair deep in the tree is
    hs3 = leaves(600)
    hs3[400] = hs3[401]
    assert M.compute_merkle_root_tpu_ex(hs3)[:2] == \
        cmerkle.compute_merkle_root(hs3)
    assert cmerkle.compute_merkle_root(hs3)[1] is True


def test_tree_edges_of_the_live_count():
    hs = leaves(128)
    words = bucket_words(hs, 128)
    for m in (0, 1):  # the root rides through from the first level
        root, mutated, witness = M.merkle_tree(words, 7, m)
        assert digest(root) == hs[0] and not bool(mutated)
        assert digest(witness) == sha256d(hs[0] + hs[0])
    root, mutated, witness = M.merkle_tree(words[:2].contiguous(), 1, 2)
    assert digest(root) == digest(witness) == sha256d(hs[0] + hs[1])
    with pytest.raises(ValueError):
        M.merkle_tree(words, 6, 77)
    with pytest.raises(ValueError):
        M.merkle_tree(words, 7, 1 << 32)


@pytest.mark.parametrize("dup", [False, True])
def test_the_root_is_read_in_one_copy(monkeypatch, dup):
    """compute_merkle_root_tpu_ex reads the tree's 17 words in one copy and
    returns what it returned when it read root, mutated and witness
    apart: 600 leaves, and 600 with the last 8 repeated (mutated)."""
    hs = leaves(600)
    if dup:
        hs = hs + hs[-8:]
    root, mutated, _witness = M.merkle_tree(bucket_words(hs, 1024), 10,
                                            len(hs))
    before = (digest(root), bool(mutated), True)
    reads = Counter(monkeypatch, M, "_to_host")
    assert M.compute_merkle_root_tpu_ex(hs) == before
    assert len(reads.calls) == 1
    assert before[:2] == cmerkle.compute_merkle_root(hs)
    assert before[1] is dup


# ---- the kernel's schedule --------------------------------------------------

POISON = (0xDEADBEEF,) * 8  # a node no block wrote
UNWRITTEN = "unwritten"  # a `mutated` word no block wrote


def _pair_hash(l: tuple, r: tuple) -> tuple:
    return struct.unpack(">8I", sha256d(struct.pack(">16I", *l, *r)))


def _advance(m: int, levels: int) -> int:
    for _ in range(levels):
        m = m if m <= 1 else (m + 1) // 2
    return m


def _or_words(words) -> bool:
    for w in words:
        assert w is not UNWRITTEN, "read a mutated word no block wrote"
    return any(words)


def model_launch_plan(n_levels: int, tree_levels: int = M.TREE_LEVELS,
                      blocks_log2: int = M.TREE_BLOCKS_LOG2):
    """The merkle_tree entry's launches, (levels a block, blocks, top): top
    -1 for a chained launch of tree_levels levels a block, 0 for a
    one-block launch, otherwise the levels the last block reduces above
    the others (at most 2**blocks_log2 blocks of at least tree_levels
    levels)."""
    plan, left = [], n_levels
    while True:
        if left <= tree_levels:
            lv, top = left, 0
        elif left <= 2 * tree_levels:
            lv = max(tree_levels, left - blocks_log2)
            top = left - lv
        else:
            lv, top = tree_levels, -1
        plan.append((lv, 1 << (left - lv), top))
        if top >= 0:
            return plan
        left -= lv


def _model_block(src, src_mut, b: int, lv: int, m: int, witness: list):
    """One block of merkle_tree_kernel's reduce_subtree: nodes
    [b << lv, (b + 1) << lv) of src through lv levels in the ping-pong
    regions; the witness (pair 0 of the tree's first level) into
    witness[0] when witness is given. Returns (root, mutated), mutated
    with the src_mut words of its inputs ORed in."""
    S = 1 << (lv - 1)
    region = ([POISON] * S, [POISON] * (S // 2))
    mutated = False
    for j in range(lv):
        src_region, out = region[(j + 1) & 1], region[j & 1]
        done = m <= 1
        for i in range(S >> j):
            gi = (b << (lv - 1 - j)) + i
            if 2 * gi >= m and gi != 0:
                continue
            live = 2 * gi + 1 < m
            node = (lambda k: src[2 * gi + k]) if j == 0 else \
                (lambda k: src_region[2 * i + k])
            l = node(0)
            r = node(1) if live else l
            if live and l == r:
                mutated = True
            is_witness = witness is not None and j == 0 and gi == 0
            if done:
                out[i] = l
            if not done or is_witness:
                h = _pair_hash(l, r)
                if is_witness:
                    witness[0] = h
                if not done:
                    out[i] = h
        if not done:
            m = (m + 1) // 2
    if src_mut is not None:
        mutated = _or_words(src_mut[b << lv:(b + 1) << lv]) or mutated
    return region[(lv - 1) & 1][0], mutated


def model_merkle_tree(leaf_words: list, n_levels: int, m: int,
                      tree_levels: int = M.TREE_LEVELS, launches=None,
                      blocks_log2: int = M.TREE_BLOCKS_LOG2):
    """csrc/sha256d_batch.cu's merkle_tree entry and merkle_tree_kernel, in
    Python: the launches of model_launch_plan (appended to ``launches``
    when given); a launch's blocks in a seeded shuffled order, each over
    its subtree with the whole tree's live count; a one-block launch
    writes the result; otherwise each block writes its root and
    `mutated` word, and in the last launch takes a ticket: the block
    that draws the last reduces the top levels over the blocks' roots and
    ORs their words. Returns (root, mutated, witness) as tuples."""
    src, src_mut = list(leaf_words), None
    witness = [POISON]
    order = random.Random(n_levels * 4099 + m)
    for k, (lv, blocks, top) in enumerate(model_launch_plan(
            n_levels, tree_levels, blocks_log2)):
        if launches is not None:
            launches.append((lv, blocks, top))
        dst, dst_mut = [POISON] * blocks, [UNWRITTEN] * blocks
        tickets = 0
        for b in order.sample(range(blocks), blocks):
            root, mutated = _model_block(src, src_mut, b, lv, m,
                                         witness if k == 0 and b == 0
                                         else None)
            if top == 0:
                result = (root, mutated)
                continue
            dst[b], dst_mut[b] = root, mutated
            if top > 0:
                tickets += 1
                if tickets == blocks:  # the last ticket: the top levels
                    root, mutated = _model_block(dst, None, 0, top,
                                                 _advance(m, lv), None)
                    result = (root, _or_words(dst_mut) or mutated)
        if top >= 0:
            return result[0], result[1], witness[0]
        src, src_mut, m = dst, dst_mut, _advance(m, lv)


def _leaf_sets(n: int) -> list:
    rng = random.Random(n)
    distinct = leaves(n, "model")
    paired = list(distinct)  # some live and dead equal pairs, a dup tail
    for i in range(0, n - 1, 5):
        paired[i + 1] = paired[i]
    paired[-1] = paired[-2]
    return [distinct, paired, [rng.choice(distinct[:3]) for _ in range(n)]]


@pytest.mark.parametrize("tree_levels", [1, 2, 3, M.TREE_LEVELS])
def test_kernel_schedule_model_equals_the_reference_rules(tree_levels):
    for n_levels in range(1, 7):
        bucket = 1 << n_levels
        for hs in _leaf_sets(bucket):
            words = [struct.unpack(">8I", h) for h in hs]
            for m in range(bucket + 1):
                root, mutated, witness = model_merkle_tree(
                    words, n_levels, m, tree_levels)
                if m == 0:
                    assert (root, mutated) == (words[0], False)
                else:
                    want = cmerkle.compute_merkle_root(hs[:m])
                    assert (struct.pack(">8I", *root), mutated) == want, \
                        (n_levels, m, tree_levels)
                pair1 = hs[1] if m >= 2 else hs[0]
                assert struct.pack(">8I", *witness) == sha256d(hs[0] + pair1)


def test_kernel_schedule_model_spreads_the_lower_blocks():
    """Blocks of more than tree_levels levels below the last block (the
    kernel's 2^16 leaves: 128 blocks of 9 levels), at small sizes: 2
    levels a block, at most 2 blocks under the last."""
    for n_levels in range(1, 7):
        bucket = 1 << n_levels
        for hs in _leaf_sets(bucket)[:2]:
            words = [struct.unpack(">8I", h) for h in hs]
            for m in range(1, bucket + 1):
                launches = []
                root, mutated, witness = model_merkle_tree(
                    words, n_levels, m, 2, launches, blocks_log2=1)
                assert (struct.pack(">8I", *root), mutated) == \
                    cmerkle.compute_merkle_root(hs[:m]), (n_levels, m)
                pair1 = hs[1] if m >= 2 else hs[0]
                assert struct.pack(">8I", *witness) == sha256d(hs[0] + pair1)
                if n_levels == 4:
                    assert launches == [(3, 2, 1)]


@pytest.mark.parametrize("m", [1, 2, 129, 256, 257, 300, 511, 512])
def test_kernel_schedule_model_takes_two_launches_at_512_leaves(m):
    """512 leaves: the kernel as built takes the two-stage launch (2 blocks
    of 8 levels, the last block's top level); with 4 levels a block, two
    launches (a chained launch of 32 blocks, then 2 blocks and a top)."""
    hs = _leaf_sets(512)[1]
    words = [struct.unpack(">8I", h) for h in hs]
    for tree_levels, plan in ((M.TREE_LEVELS, [(8, 2, 1)]),
                              (4, [(4, 32, -1), (4, 2, 1)])):
        launches = []
        root, mutated, witness = model_merkle_tree(words, 9, m, tree_levels,
                                                   launches)
        assert launches == plan
        assert (struct.pack(">8I", *root), mutated) == \
            cmerkle.compute_merkle_root(hs[:m])
        assert struct.pack(">8I", *witness) == \
            sha256d(hs[0] + (hs[1] if m >= 2 else hs[0]))


@pytest.mark.parametrize("n_levels,ms", [
    (12, [4096, 3073, 2049, 2, 1]), (16, [49153])])
def test_kernel_schedule_model_takes_one_launch_to_16_levels(n_levels, ms):
    bucket = 1 << n_levels
    hs = leaves(bucket, "one-launch")
    hs[bucket // 2 + 7] = hs[bucket // 2 + 6]  # a live equal pair
    words = [struct.unpack(">8I", h) for h in hs]
    for m in ms:
        launches = []
        root, mutated, witness = model_merkle_tree(words, n_levels, m,
                                                   launches=launches)
        assert launches == [{12: (8, 16, 4), 16: (9, 128, 7)}[n_levels]]
        assert (struct.pack(">8I", *root), mutated) == \
            cmerkle.compute_merkle_root(hs[:m])
        assert struct.pack(">8I", *witness) == \
            sha256d(hs[0] + (hs[1] if m >= 2 else hs[0]))


def test_kernel_launch_plan_is_one_launch_to_2_16_leaves_and_chains_above():
    assert model_launch_plan(9) == [(8, 2, 1)]
    assert model_launch_plan(12) == [(8, 16, 4)]
    assert model_launch_plan(15) == [(8, 128, 7)]
    assert model_launch_plan(16) == [(9, 128, 7)]  # one block an SM
    assert all(len(model_launch_plan(n)) == 1 for n in range(1, 17))
    assert model_launch_plan(17) == [(8, 512, -1), (8, 2, 1)]
    assert model_launch_plan(24) == [(8, 65536, -1), (9, 128, 7)]
    assert model_launch_plan(25) == [(8, 1 << 17, -1), (8, 512, -1),
                                     (8, 2, 1)]
    # every level reduced once, by blocks of at most 8 levels
    for n in range(1, 41):
        plan = model_launch_plan(n)
        assert sum(lv for lv, _b, _t in plan) + max(plan[-1][2], 0) == n
        assert len(plan) == max(1, (n - 9) // 8 + 1)


@pytest.mark.parametrize("m", [0, 1, 2, 33, 64, 65, 100, 127, 128])
def test_kernel_schedule_model_equals_the_plain_tree(m):
    hs = _leaf_sets(128)[1]
    words = bucket_words(hs, 128)
    root, mutated, witness = M.tree_reduce_plain(words, 7, m)
    want = (tuple(int(w) & 0xFFFFFFFF for w in root), bool(mutated),
            tuple(int(w) & 0xFFFFFFFF for w in witness))
    rows = [struct.unpack(">8I", h) for h in hs]
    for tree_levels in (3, M.TREE_LEVELS):
        assert model_merkle_tree(rows, 7, m, tree_levels) == want


# ---- the pair hash ----------------------------------------------------------

def test_hash_pairs_equals_the_jax_program_and_hashlib():
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 1 << 32, (128, 16), dtype=np.uint64) \
        .astype(np.uint32)
    with jax.disable_jit():
        ref = np.asarray(jmerkle._hash_pairs_jit(jnp.asarray(rows)))
    got = M.hash_pairs_words(torch.from_numpy(rows.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    for i in range(0, 128, 17):
        assert digest(got[i]) == sha256d(struct.pack(">16I", *rows[i]))


@pytest.mark.parametrize("n", [1, 127, 128, 1000])
def test_sha256d_pairs_equals_hashlib(n, monkeypatch):
    calls = Counter(monkeypatch, M, "hash_pairs_words")
    pairs = [a + b for a, b in zip(leaves(n, "l"), leaves(n, "r"))]
    assert M.sha256d_pairs(pairs) == [sha256d(p) for p in pairs]
    assert len(calls.calls) == (n >= M.PAD_LANES)
    assert M.sha256d_pairs([]) == []


# ---- ops/dispatch.merkle_root: the gate and the CPU confirmation ----------

def test_the_gate_sends_512_leaves_to_the_tree(monkeypatch):
    tree = Counter(monkeypatch, M, "merkle_tree_words")
    host = Counter(monkeypatch, cmerkle, "compute_merkle_root")
    for n, want_tree in ((511, 0), (512, 1)):
        hs = leaves(n)
        want = cmerkle.merkle_root_naive(hs)
        tree.calls.clear()
        host.calls.clear()
        assert dispatch.merkle_root(hs, expected=want) == (want, False)
        assert len(tree.calls) == want_tree
        assert len(host.calls) == 1 - want_tree
    monkeypatch.setenv("BCP_TPU_MERKLE_MIN", "100")
    assert dispatch._merkle_device_min() == 100
    tree.calls.clear()
    dispatch.merkle_root(leaves(100))
    assert len(tree.calls) == 1


def _lie(monkeypatch, how: str):
    plain = M.tree_reduce_plain

    def lying(words, n_levels, m):
        root, mutated, witness = plain(words, n_levels, m)
        if how == "root":  # the last level's output altered
            root = root.clone()
            root[3] ^= 1
        else:
            mutated = torch.ones((), dtype=torch.bool)
        return root, mutated, witness

    monkeypatch.setattr(M, "tree_reduce_plain", lying)


@pytest.mark.parametrize("how", ["root", "mutated"])
def test_a_lying_device_is_confirmed_back(monkeypatch, how):
    hs = leaves(700)
    want = cmerkle.compute_merkle_root(hs)
    _lie(monkeypatch, how)
    host = Counter(monkeypatch, cmerkle, "compute_merkle_root")
    assert dispatch.merkle_root(hs, expected=want[0]) == want
    assert len(host.calls) == 1
    # without a claimed root, a lying root passes the witness probe: the
    # caller's header compare is what catches it (bad-txnmrklroot)
    if how == "root":
        assert dispatch.merkle_root(hs)[0] != want[0]


def test_a_duplicate_leaf_is_confirmed_on_the_host(monkeypatch):
    hs = leaves(700)
    hs[650] = hs[3]  # a duplicate that forms no pair: not mutated
    host = Counter(monkeypatch, cmerkle, "compute_merkle_root")
    want = cmerkle.merkle_root_naive(hs)
    assert dispatch.merkle_root(hs, expected=want) == (want, False)
    assert len(host.calls) == 1


def test_injected_faults_keep_the_verdict(monkeypatch):
    hs = leaves(600)
    want = cmerkle.compute_merkle_root(hs)
    for mode in ("poison-output", "fail-always"):
        monkeypatch.setenv("BCP_FAULT_MODE", mode)
        monkeypatch.setenv("BCP_FAULT_OPS", "merkle")
        faults.INJECTOR.reload()
        dispatch.reset()
        assert M.compute_merkle_root_tpu_ex(hs) == (*want, False)
        assert dispatch.merkle_root(hs, expected=want[0]) == want
        assert dispatch.breaker("merkle").snapshot()["fallback_calls"] == 2


def test_an_uninjected_witness_mismatch_raises(monkeypatch):
    plain = M.tree_reduce_plain

    def lying(words, n_levels, m):
        root, mutated, witness = plain(words, n_levels, m)
        return root, mutated, witness ^ 1

    monkeypatch.setattr(M, "tree_reduce_plain", lying)
    with pytest.raises(KernelUnavailable, match="merkle"):
        dispatch.merkle_root(leaves(600))
    cuda_build.set_device("cuda")
    monkeypatch.setattr(M, "tree_reduce_plain", plain)
    if not torch.cuda.is_available():
        with pytest.raises(KernelUnavailable):
            dispatch.merkle_root(leaves(600))


# ---- CheckBlock ---------------------------------------------------------------

def _dummy_block(n_txs: int) -> CBlock:
    coinbase = CTransaction(
        version=1, vin=(CTxIn(COutPoint(), b"\x01\x02merkle", 0xFFFFFFFF),),
        vout=(CTxOut(50, b"\x51"),))
    txs = [coinbase] + [
        CTransaction(version=1,
                     vin=(CTxIn(COutPoint(hashlib.sha256(
                         str(i).encode()).digest(), 0), b"", 0xFFFFFFFF),),
                     vout=(CTxOut(1000 + i, b"\x51"),))
        for i in range(n_txs - 1)]
    root, _ = cmerkle.compute_merkle_root([tx.txid for tx in txs])
    header = CBlockHeader(version=1, hash_merkle_root=root,
                          time=1_600_000_000, bits=0x207FFFFF)
    return CBlock(header, tuple(txs))


def test_check_block_merkle_rules_on_a_600_leaf_block(monkeypatch):
    params = regtest_params()
    cs = ChainstateManager(params, MemoryCoinsView(), MemoryBlockStore(),
                           script_verifier=None)
    tree = Counter(monkeypatch, M, "merkle_tree_words")
    block = _dummy_block(600)
    cs.check_block(block, check_pow=False)
    # 600 leaves: the third level has 75 nodes, so repeating the last 8
    # leaves keeps the root and mutates the tree
    mutated = CBlock(block.header, block.vtx + block.vtx[-8:])
    with pytest.raises(BlockValidationError, match="bad-txns-duplicate"):
        cs.check_block(mutated, check_pow=False)
    bad_root = CBlock(dataclasses.replace(block.header,
                                          hash_merkle_root=b"\x07" * 32),
                      block.vtx)
    with pytest.raises(BlockValidationError, match="bad-txnmrklroot"):
        cs.check_block(bad_root, check_pow=False)
    assert len(tree.calls) == 3


# ---- the certificate MMR --------------------------------------------------------

def _oracle_mmr(hs: list) -> bytes:
    def tree(ls):
        if len(ls) == 1:
            return ls[0]
        mid = len(ls) // 2
        return sha256d(tree(ls[:mid]) + tree(ls[mid:]))

    peaks, pos, n = [], 0, len(hs)
    for bit in range(n.bit_length() - 1, -1, -1):
        if n & (1 << bit):
            peaks.append(tree(hs[pos:pos + (1 << bit)]))
            pos += 1 << bit
    acc = peaks[-1]
    for p in reversed(peaks[:-1]):
        acc = sha256d(p + acc)
    return acc


def test_certificate_mmr_reaches_the_pair_hash(monkeypatch):
    pairs = Counter(monkeypatch, M, "hash_pairs_words")
    hs = leaves(2000, "hdr")
    assert certificate.mmr_root(hs) == _oracle_mmr(hs)
    # 2000 = 1024 + 512 + 256 + 128 + 64 + 16: the levels of 128 pairs or
    # more (512, 256, 128; 256, 128; 128) take the pair hash
    assert [len(c) for c in pairs.calls] == [512, 256, 128, 256, 128, 128]


def test_certificate_golden_mmr_root():
    with open(os.path.join(FIXTURES, "snapshot_cert_golden.json")) as f:
        golden = json.load(f)
    hs = [hashlib.sha256(f"hdr:{i}".encode()).digest()
          for i in range(golden["certificate"]["headers"])]
    assert certificate.mmr_root(hs).hex() == \
        golden["certificate"]["mmr_root"]
