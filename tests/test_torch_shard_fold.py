"""The port's sharded MSM and nonce paths (parallel/sig_shard.py and
parallel/nonce_shard.py; K13) on the CPU: one launch of an already ported
kernel a shard (its plain version here, the tensors lying on the CPU),
folded on the host as the reference's collectives were.

- ``msm_is_infinity_sharded`` at widths 1, 2 and 4 on terms of known
  discrete logs, its sum zero and nonzero, one layout with shards that
  hold only padding: the verdict equal to the host's sum, each shard's
  partial equal to the host's sum of that shard's terms.
- ``sweep_header_sharded`` at widths 1, 4 and 8: the nonce, the hashes
  and the per-shard tiles equal to the reference's stripe rule computed
  with hashlib (shard c sweeps [start + c n_tiles tile, ...) mod 2^32,
  each stopping after the tile of its first hit), the width-1 nonce to the
  unsharded exact sweep's; a start near 2^32 whose stripes wrap, with the
  one hit at 0xFFFFFFFF (the fold must not take it for "none"); a block
  mined through ``generate_blocks(..., sweep=sweep_header_sharded)``.

The JAX sharded programs are never compiled: their XLA compile costs
minutes on the CPU. Every comparison is exact.
"""

import functools
import hashlib
import random

import pytest
import torch

from bitcoincashplus_tpu_torch.crypto import secp256k1 as oracle
from bitcoincashplus_tpu_torch.ops import cuda_build
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
from bitcoincashplus_tpu_torch.ops import miner
from bitcoincashplus_tpu_torch.parallel import mesh, nonce_shard, sig_shard

P, N, G = oracle.P, oracle.N, oracle.G
M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    cuda_build.set_device("cpu")
    yield


# ---- the sharded MSM --------------------------------------------------------

def msm_terms(m: int, seed: int, zero_sum: bool) -> tuple:
    """m terms k_j Q_j with Q_j = c_j G of known logs (consecutive c, so
    the points are a chain of adds), a pair P == Q and a pair P == -Q among
    them; zero_sum picks the last scalar so that the sum is infinity.
    Returns (terms, logs)."""
    rng = random.Random(seed)
    c0 = rng.randrange(1, N)
    logs, pts = [c0], [oracle.point_mul(c0, G)]
    for _ in range(m - 3):
        logs.append((logs[-1] + 1) % N)
        pts.append(oracle.point_add(pts[-1], G))
    logs += [logs[0], N - logs[1]]
    pts += [pts[0], (pts[1][0], P - pts[1][1])]
    ks = [rng.randrange(1, N) for _ in range(m)]
    if zero_sum:
        rest = sum(k * c for k, c in zip(ks[:-1], logs[:-1])) % N
        ks[-1] = -rest * pow(logs[-1], N - 2, N) % N
    return [(x, y, k) for (x, y), k in zip(pts, ks)], logs


def host_sum(terms, logs):
    s = sum(k * c for (_, _, k), c in zip(terms, logs)) % N
    return None if s == 0 else oracle.point_mul(s, G)


@pytest.mark.parametrize("zero_sum", [False, True], ids=["nonzero", "zero"])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_msm_is_infinity_sharded_matches_the_host_sum(width, zero_sum):
    """100 terms: width 1 is one 256-term shard, width 2 two 64-term
    shards (64 and 36 terms), width 4 four (64, 36 and two of padding
    alone, each at infinity and skipped by the fold)."""
    terms, logs = msm_terms(100, 40 + width, zero_sum)
    want = host_sum(terms, logs)
    assert (want is None) == zero_sum
    assert sig_shard.msm_is_infinity_sharded(terms, width) is zero_sum


def test_msm_shard_partials_are_the_shards_sums():
    """Each shard's partial (the Jacobian triple of msm_partial_point's
    launch) is the host's sum of that shard's terms; shards holding only
    padding are at infinity."""
    terms, logs = msm_terms(100, 7, False)
    arrays = E._msm_pack(terms, 256)
    parts = sig_shard._sharded_msm(*arrays, devices=mesh.chip_mesh(4))
    for c, ((x, y, z), inf) in enumerate(parts):
        want = host_sum(terms[64 * c:64 * (c + 1)], logs[64 * c:64 * (c + 1)])
        assert inf is (want is None)
        if want is not None:
            zi = pow(z, P - 2, P)
            assert (x * zi * zi % P, y * zi ** 3 % P) == want
    assert [inf for _, inf in parts] == [False, False, True, True]


# ---- the sharded nonce sweep -------------------------------------------------

def pow_hash(header80: bytes, nonce: int) -> int:
    h = hashlib.sha256(hashlib.sha256(
        header80[:76] + nonce.to_bytes(4, "little")).digest()).digest()
    return int.from_bytes(h, "little")


def stripe_rule(header80, target, start, max_nonces, tile, width):
    """The reference's sharded sweep with hashlib: (nonce or None, hashes,
    per-shard tiles)."""
    n_tiles = max(1, max_nonces // width // tile)
    best, tiles = None, []
    for c in range(width):
        base = start + c * n_tiles * tile
        done = n_tiles
        for i in range(n_tiles * tile):
            nonce = (base + i) & M32
            if pow_hash(header80, nonce) <= target:
                done = i // tile + 1
                best = nonce if best is None else min(best, nonce)
                break
        tiles.append(done)
    return best, sum(tiles) * tile, tiles


def header(seed: int) -> bytes:
    return random.Random(seed).randbytes(76) + bytes(4)


@pytest.mark.parametrize("width", [1, 4, 8])
def test_sweep_header_sharded_follows_the_stripe_rule(width):
    """From start 0 at a target that hits about once in 2^10 nonces: the
    folded nonce, hashes and per-shard tiles equal the stripe rule's; at
    width 1 the nonce is the unsharded exact sweep's first hit."""
    hdr, target, tile, budget = header(3), 1 << 246, 256, 1 << 13
    got = nonce_shard.sweep_header_sharded(hdr, target, 0, budget, tile=tile,
                                           n_chips=width,
                                           return_per_chip=True)
    assert got == stripe_rule(hdr, target, 0, budget, tile, width)
    assert got[0] is not None
    if width == 1:
        assert got[0] == miner.sweep_header(hdr, target, 0, budget, tile)[0]


def _top_hit_header():
    """A header whose nonce 0xFFFFFFFF hashes at or below 2^244 and no
    other nonce of [2^32 - 64, 2^32) or [0, 64) does, and that target."""
    rng = random.Random(5)
    window = [(M32 - 63 + i) & M32 for i in range(128)]
    while True:
        hdr = rng.randbytes(76) + bytes(4)
        t = pow_hash(hdr, M32)
        if t <= 1 << 244 and all(pow_hash(hdr, n) > t
                                 for n in window if n != M32):
            return hdr, t


def test_a_lone_hit_at_the_top_nonce_survives_the_fold():
    """Width 4 from 2^32 - 64, 2 tiles of 16 a shard: shard 1 ends at
    0xFFFFFFFF, shards 2 and 3 wrap to [0, 64). The only hit is
    0xFFFFFFFF, the key a shard without a hit contributes: any_found keeps
    it."""
    hdr, target = _top_hit_header()
    got = nonce_shard.sweep_header_sharded(hdr, target, M32 - 63, 128,
                                           tile=16, n_chips=4,
                                           return_per_chip=True)
    assert got == (M32, 128, [2, 2, 2, 2])
    assert got == stripe_rule(hdr, target, M32 - 63, 128, 16, 4)


def test_wrapped_stripes_near_the_top_follow_the_stripe_rule():
    """From 2^32 - 3 * 2^11 at width 8 (2^11-nonce stripes): shards 3..7
    start past the wrap, mod 2^32."""
    hdr, target, start = header(11), 1 << 245, (1 << 32) - 3 * 2048
    got = nonce_shard.sweep_header_sharded(hdr, target, start, 8 * 2048,
                                           tile=512, n_chips=8,
                                           return_per_chip=True)
    assert got == stripe_rule(hdr, target, start, 8 * 2048, 512, 8)


def test_the_fold_keeps_a_lone_top_hit_and_reports_none_without_one(
        monkeypatch):
    """The host fold alone, on crafted shard results: the smallest found
    nonce wins; a lone hit at 0xFFFFFFFF is a hit; no hit is None; tiles
    summed and kept per shard."""
    results = iter([])

    def fake(tmpl, tgt, start, n_tiles, tile):
        return torch.tensor(next(results), dtype=torch.int64)

    monkeypatch.setattr(nonce_shard, "sweep", fake)
    for shards, want in (
            ([(0, 0, 4), (1, M32, 3), (0, 0, 4)], (M32, 11 * 8, [4, 3, 4])),
            ([(1, 9, 1), (1, 7, 2), (0, 0, 4)], (7, 7 * 8, [1, 2, 4])),
            ([(0, 0, 4)] * 3, (None, 12 * 8, [4, 4, 4]))):
        results = iter(shards)
        got = nonce_shard.sweep_header_sharded(bytes(80), 1, 0, 3 * 4 * 8,
                                               tile=8, n_chips=3,
                                               return_per_chip=True)
        assert got == want


def test_generate_blocks_through_the_sharded_sweep():
    """generate_blocks with sweep=sweep_header_sharded at width 2: the
    blocks connect, and their hashes meet their targets."""
    from bitcoincashplus_tpu_torch.consensus.params import regtest_params
    from bitcoincashplus_tpu_torch.consensus.pow import compact_to_target
    from bitcoincashplus_tpu_torch.mining.generate import generate_blocks
    from bitcoincashplus_tpu_torch.store.blockstore import MemoryBlockStore
    from bitcoincashplus_tpu_torch.validation.chainstate import \
        ChainstateManager
    from bitcoincashplus_tpu_torch.validation.coins import MemoryCoinsView

    clock = iter(range(1_600_000_000, 1_700_000_000, 60))
    cs = ChainstateManager(regtest_params(), MemoryCoinsView(),
                           MemoryBlockStore(), get_time=lambda: next(clock))
    sweep = functools.partial(nonce_shard.sweep_header_sharded, n_chips=2)
    hashes = generate_blocks(cs, b"\x51", 2, tile=1 << 10, sweep=sweep)
    assert len(hashes) == 2 and cs.tip().height == 2
    assert cs.tip().hash == hashes[-1]
    for h in hashes:
        bits = cs.block_index[h].header.bits
        assert int.from_bytes(h, "little") <= compact_to_target(bits)[0]
