"""The port's batch header hash (K1: bitcoincashplus_tpu_torch/ops/
sha256.py, csrc/sha256d_batch.cu) and consensus/pow.check_headers_pow_batch
on the CPU device — the plain PyTorch versions stand in for the CUDA
kernels — against the JAX package and the oracles it is tested against
(hashlib, per-header check_proof_of_work).

Tolerance: exact equality everywhere (integer hashing, boolean verdicts).

Cost: the JAX sha256d_80 runs eagerly under jax.disable_jit() (its jit
is minutes of XLA compile on a CPU); 16 headers take a few seconds.
"""

import hashlib
import os
import random
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoincashplus_tpu.ops import sha256 as jsha
from bitcoincashplus_tpu_torch.consensus.block import CBlockHeader
from bitcoincashplus_tpu_torch.consensus import params as P
from bitcoincashplus_tpu_torch.consensus.pow import (check_headers_pow_batch,
                                                     check_proof_of_work,
                                                     compact_to_target)
from bitcoincashplus_tpu_torch.crypto import hashes
from bitcoincashplus_tpu_torch.ops import cuda_build, dispatch
from bitcoincashplus_tpu_torch.ops import sha256 as S
from bitcoincashplus_tpu_torch.ops.cuda_build import KernelUnavailable
from bitcoincashplus_tpu_torch.util import faults

GENESIS = bytes.fromhex(
    "0100000000000000000000000000000000000000000000000000000000000000"
    "000000003ba3edfd7a7b12b27ac72c3e67768f617fc81bc3888a51323a9fb8aa"
    "4b1e5e4a29ab5f49ffff001d1dac2b7c")
DIFF1_BITS = 0x1d00ffff
REGTEST = P.regtest_params().consensus


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
    faults.INJECTOR.reload()
    dispatch.reset()
    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    cuda_build.set_device("cpu")
    yield
    faults.INJECTOR.reload()
    dispatch.reset()


def sha256d(b: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(b).digest()).digest()


def random_headers(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 80), dtype=np.uint8)


def words_tensor(headers: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(S.headers_to_words_np(headers).view(np.int32))


def test_plain_sha256d_80_equals_the_jax_function():
    headers = np.concatenate([random_headers(16, 1),
                              np.frombuffer(GENESIS, np.uint8)[None]])
    words = S.headers_to_words_np(headers)
    with jax.disable_jit():
        ref = jsha.sha256d_80([jnp.asarray(words[:, i]) for i in range(20)])
    ref = np.stack([np.asarray(h) for h in ref], axis=1).astype(np.uint32)
    got = S.sha256d_80(list(S.words64(words_tensor(headers)).unbind(1)))
    got = torch.stack(got, dim=1).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, ref)
    out = S.sha256d_headers_words(words_tensor(headers)).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref)
    # the genesis block's hash, wire order
    assert S.sha256d_headers(headers)[-1].tobytes()[::-1].hex() == (
        "000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f")


@pytest.mark.parametrize("batch", [1, 16, 17, 2048])
def test_sha256d_headers_equals_hashlib(batch):
    headers = random_headers(batch, batch)
    got = S.sha256d_headers(headers)
    assert got.shape == (batch, 32) and got.dtype == np.uint8
    for i in range(batch):
        assert got[i].tobytes() == sha256d(headers[i].tobytes()), i


def test_plain_versions_of_the_pieces_equal_the_oracles():
    from bitcoincashplus_tpu_torch.crypto.hashes import (SHA256_INIT,
                                                         sha256_compress)

    block = bytes(range(64))
    w16 = list(struct.unpack(">16I", block))
    assert tuple(S.compress(list(SHA256_INIT), w16)) == \
        sha256_compress(SHA256_INIT, block)
    msg = bytes(range(100, 164))
    got = S.sha256d_64(list(struct.unpack(">16I", msg)))
    assert struct.pack(">8I", *got) == sha256d(msg)
    h8 = list(struct.unpack(">8I", hashlib.sha256(b"x").digest()))
    assert struct.pack(">8I", *S.sha256_of_state(h8)) == \
        hashlib.sha256(hashlib.sha256(b"x").digest()).digest()


def test_check_headers_pow_words_compares_as_le256():
    headers = random_headers(8, 5)
    digests = [int.from_bytes(sha256d(h.tobytes()), "little")
               for h in headers]
    words = words_tensor(headers)
    for i, d in enumerate(digests):
        for target, want in ((d, True), (d - 1, False), (d + 1, True)):
            tgt = torch.from_numpy(S.target_to_limbs_np(target).view(np.int32))
            out, ok = S.check_headers_pow_words(words, tgt)
            assert bool(ok[i]) is want, (i, target - d)
            np.testing.assert_array_equal(
                ok.numpy(), [x <= target for x in digests])
            np.testing.assert_array_equal(
                out, S.sha256d_headers_words(words))


def regtest_header_chain(n: int, seed: int = 3) -> list:
    """n mined regtest headers, each on the last (difficulty 1 regtest:
    about two nonce tries a header)."""
    params = P.regtest_params()
    target, _ = compact_to_target(params.genesis.header.bits)
    rng = random.Random(seed)
    prev = params.genesis.header.get_hash()
    out = []
    for i in range(n):
        h = CBlockHeader(version=0x20000000, hash_prev_block=prev,
                         hash_merkle_root=rng.randbytes(32),
                         time=params.genesis.header.time + 60 * (i + 1),
                         bits=params.genesis.header.bits, nonce=0)
        while int.from_bytes(h.get_hash(), "little") > target:
            h = h.with_nonce(h.nonce + 1)
        out.append(h.serialize())
        prev = h.get_hash()
    return out


def headers_under_test() -> list:
    """A regtest header chain, a header at testnet's difficulty 1 whose
    nonce misses, one with bits that decode negative and one above the
    pow limit."""
    chain = regtest_header_chain(40)
    miss = CBlockHeader(version=1, hash_merkle_root=b"\x11" * 32,
                        time=1_600_000_000, bits=DIFF1_BITS, nonce=7)
    assert int.from_bytes(miss.get_hash(), "little") > \
        compact_to_target(DIFF1_BITS)[0]
    raw_neg = bytearray(chain[5])
    raw_neg[72:76] = (0x04923456).to_bytes(4, "little")
    raw_big = bytearray(chain[6])
    raw_big[72:76] = (0x2100FFFF).to_bytes(4, "little")
    return chain[:20] + [miss.serialize(), bytes(raw_neg), bytes(raw_big),
                         GENESIS] + chain[20:]


@pytest.mark.parametrize("network", ["regtest", "test"])
def test_check_headers_pow_batch_equals_per_header_check(network):
    params = P.select_params(network).consensus
    headers = headers_under_test()
    got = check_headers_pow_batch(headers, params)
    want = [check_proof_of_work(sha256d(h), int.from_bytes(h[72:76],
                                                           "little"), params)
            for h in headers]
    assert got == want
    assert any(want) and not all(want)
    assert check_headers_pow_batch([], params) == []


def test_a_corrupted_lane_is_confirmed_on_the_host(monkeypatch):
    headers = regtest_header_chain(20)
    plain = S.sha256d_headers_plain

    def lying(words):  # lane 3's digest made to fail every target
        out = plain(words).clone()
        out[3] = -1
        return out

    monkeypatch.setattr(S, "sha256d_headers_plain", lying)
    arr = np.frombuffer(b"".join(headers), np.uint8).reshape(-1, 80)
    assert S.sha256d_headers(arr)[3].tobytes() == b"\xff" * 32
    calls = []
    real = hashes.sha256d
    monkeypatch.setattr(hashes, "sha256d",
                        lambda b: calls.append(b) or real(b))
    assert check_headers_pow_batch(headers, REGTEST) == [True] * 20
    # lane 0's spot check, and one host confirmation: lane 3's
    assert sorted(calls) == sorted([headers[0], headers[3]])


def test_an_injected_poison_keeps_the_cpu_engines_digests(monkeypatch):
    monkeypatch.setenv("BCP_FAULT_MODE", "poison-output")
    monkeypatch.setenv("BCP_FAULT_OPS", "sha256")
    faults.INJECTOR.reload()
    headers = random_headers(17, 9)
    got = S.sha256d_headers(headers)
    np.testing.assert_array_equal(got, S.sha256d_headers_cpu(headers))
    snap = dispatch.breaker("sha256").snapshot()
    assert snap["fallback_calls"] == 1 and snap["fallback_items"] == 17
    assert faults.INJECTOR.poisoned["sha256"] >= 1
    chain = regtest_header_chain(8)
    assert check_headers_pow_batch(chain, REGTEST) == [True] * 8


def test_an_uninjected_lane0_mismatch_raises(monkeypatch):
    plain = S.sha256d_headers_plain

    def lying(words):
        out = plain(words).clone()
        out[0, 0] ^= 1
        return out

    monkeypatch.setattr(S, "sha256d_headers_plain", lying)
    with pytest.raises(KernelUnavailable, match="sha256"):
        S.sha256d_headers(random_headers(16, 4))
    assert dispatch.breaker("sha256").snapshot()["fallback_calls"] == 0


def test_the_cuda_leg_without_a_card_raises():
    cuda_build.set_device("cuda")
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs this leg")
    with pytest.raises(KernelUnavailable):
        S.sha256d_headers(random_headers(16, 6))
    with pytest.raises(KernelUnavailable):
        check_headers_pow_batch(regtest_header_chain(2), REGTEST)


def test_the_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        S.sha256d_headers_words(torch.zeros((4, 19), dtype=torch.int32))
    with pytest.raises(ValueError):
        S.sha256d_headers_words(torch.zeros((4, 20), dtype=torch.int64))
    with pytest.raises(ValueError):
        S.check_headers_pow_words(torch.zeros((4, 20), dtype=torch.int32),
                                  torch.zeros(7, dtype=torch.int32))
    assert S.sha256d_headers(np.zeros((0, 80), np.uint8)).shape == (0, 32)
