"""The port's mining path (bitcoincashplus_tpu_torch/mining/, the
supervised sweeps of ops/dispatch.py) on the CPU device — the plain
PyTorch sweeps stand in for the CUDA kernels — against the JAX package:
generate_blocks on regtest, byte-identical mined blocks, ResidentSweep
against the scalar oracle across template swaps, and the supervision
rules (a broken kernel raises; an injected fault takes the scalar loop).

Tolerance: exact equality (integer hashing; block bytes).

The JAX package's sweeps run eagerly under jax.disable_jit() with their
per-tile hash evaluated on numpy arrays (as in tests/test_torch_sweep.py):
a jit compile of them costs minutes on a CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoincashplus_tpu.consensus.params import regtest_params as jparams
from bitcoincashplus_tpu.mining.generate import generate_blocks as jgenerate
from bitcoincashplus_tpu.mining.generate import mine_block as jmine_block
from bitcoincashplus_tpu.mining.assembler import BlockAssembler as JAssembler
from bitcoincashplus_tpu.ops import miner as jmi
from bitcoincashplus_tpu.ops.miner import sweep_header_cpu as jsweep_cpu
from bitcoincashplus_tpu.store.blockstore import MemoryBlockStore as JStore
from bitcoincashplus_tpu.validation.chainstate import (
    ChainstateManager as JChainstate)
from bitcoincashplus_tpu.validation.coins import MemoryCoinsView as JView
from bitcoincashplus_tpu_torch.consensus.params import regtest_params
from bitcoincashplus_tpu_torch.consensus.pow import compact_to_target
from bitcoincashplus_tpu_torch.crypto.hashes import sha256d
from bitcoincashplus_tpu_torch.mining import resident as R
from bitcoincashplus_tpu_torch.mining.assembler import BlockAssembler
from bitcoincashplus_tpu_torch.mining.generate import (generate_blocks,
                                                       mine_block)
from bitcoincashplus_tpu_torch.ops import cuda_build, dispatch
from bitcoincashplus_tpu_torch.ops import miner as MI
from bitcoincashplus_tpu_torch.ops import pallas_sweep as PS
from bitcoincashplus_tpu_torch.ops import sha256_sweep as SW
from bitcoincashplus_tpu_torch.store.blockstore import MemoryBlockStore
from bitcoincashplus_tpu_torch.util import devicewatch as dw
from bitcoincashplus_tpu_torch.util import faults
from bitcoincashplus_tpu_torch.validation.chainstate import ChainstateManager
from bitcoincashplus_tpu_torch.validation.coins import MemoryCoinsView

TILE = 1 << 10
EASY = 0x7FFFFF << (8 * 29)
SPK = bytes.fromhex("76a914") + bytes(range(20)) + bytes.fromhex("88ac")


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


def _np_pre(pre):
    if isinstance(pre, dict):
        return {k: _np_pre(v) for k, v in pre.items()}
    if isinstance(pre, (list, tuple)):
        return type(pre)(_np_pre(v) for v in pre)
    return np.uint32(np.asarray(pre))


@pytest.fixture(scope="module")
def jax_eager():
    """The JAX exact sweep runs eagerly, its per-tile digest on numpy."""
    digest = jmi.sweep_digest_hoisted

    def numpy_digest(pre, nonces):
        return [jnp.asarray(x) for x in digest(
            _np_pre(pre), np.asarray(nonces, dtype=np.uint32))]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmi, "sweep_digest_hoisted", numpy_digest)
        with jax.disable_jit():
            yield


def _clock():
    t = [1_600_000_000]

    def now():
        t[0] += 60
        return t[0]
    return now


def _port_chain():
    return ChainstateManager(regtest_params(), MemoryCoinsView(),
                             MemoryBlockStore(), get_time=_clock())


def _jax_chain():
    return JChainstate(jparams(), JView(), JStore(), get_time=_clock())


def _check_chain(cs, hashes, n):
    assert len(hashes) == n and cs.tip().height == n
    for h in hashes:
        idx = cs.block_index[h]
        assert int.from_bytes(h, "little") <= compact_to_target(
            idx.header.bits)[0]
    assert cs.tip().hash == hashes[-1]


def test_generate_blocks_matches_jax(jax_eager):
    """generatetoaddress on regtest: the same block count and tip height,
    every hash at or under its target, on both packages' default
    (supervised exact) sweep."""
    cs, jcs = _port_chain(), _jax_chain()
    hashes = generate_blocks(cs, SPK, 3, tile=TILE)
    jhashes = jgenerate(jcs, SPK, 3, tile=TILE)
    _check_chain(cs, hashes, 3)
    assert len(jhashes) == 3 and jcs.tip().height == cs.tip().height
    assert dispatch.breaker("miner").snapshot()["fallback_calls"] == 0


def test_mined_block_is_byte_identical_to_jax(jax_eager):
    """A pinned block time and extranonce make the template identical, so
    the first passing nonce and the whole block are too."""
    cs, jcs = _port_chain(), _jax_chain()
    t = cs.tip().get_median_time_past() + 1
    block = mine_block(BlockAssembler(cs), SPK, tile=TILE, time_override=t,
                       extranonce_start=41)
    jblock = jmine_block(JAssembler(jcs), SPK, tile=TILE, time_override=t,
                         extranonce_start=41)
    assert block.serialize() == jblock.serialize()
    assert cs.process_new_block(block) and cs.tip().hash == block.get_hash()


def _engines():
    return {
        "h7": dispatch.supervised_sweep(inner=SW.sweep_header_fast),
        "pallas-h7": dispatch.supervised_sweep(
            inner=lambda h, t, start_nonce, max_nonces, tile:
            PS.sweep_header_pallas(h, t, start_nonce, max_nonces,
                                   sublanes=TILE // PS.LANES, max_tiles=4)),
        "resident-exact": dispatch.supervised_resident_sweep(
            R.ResidentSweep(tile=TILE, seg_tiles=2, inflight=2,
                            kernel="exact")),
        "resident-h7": dispatch.supervised_resident_sweep(
            R.ResidentSweep(tile=TILE, seg_tiles=2, inflight=2,
                            kernel="h7")),
    }


@pytest.mark.parametrize("engine", ["h7", "pallas-h7", "resident-exact",
                                    "resident-h7"])
def test_every_engine_mines_connected_blocks(engine):
    cs = _port_chain()
    before = dict(SW.LAUNCHES)
    hashes = generate_blocks(cs, SPK, 2, tile=TILE, sweep=_engines()[engine])
    _check_chain(cs, hashes, 2)
    assert dispatch.breaker("miner").snapshot()["fallback_calls"] == 0
    assert SW.LAUNCHES == before  # the plain versions do not count


# ---- the resident loop ------------------------------------------------------

@pytest.mark.parametrize("kernel", ["exact", "h7"])
def test_resident_matches_cpu_oracle_across_a_template_swap(kernel):
    """Segments of template A are in flight when template B arrives: they
    are discarded, the hit comes from B, and the launch shape stays one."""
    rs = R.ResidentSweep(tile=1 << 9, seg_tiles=2, inflight=2, kernel=kernel)
    try:
        header_a, header_b = b"\x11" * 80, b"\x22" * 80
        rs.set_template(header_a, 0)
        rs._pump(1 << 12)
        assert len(rs._segments) == 2
        n, hashes = rs.sweep(header_b, EASY, max_nonces=1 << 13)
        n_cpu, _ = jsweep_cpu(header_b, EASY, max_nonces=1 << 13)
        assert n == n_cpu and n_cpu < hashes
        assert rs.buffer_swaps == 2 and rs.segments_discarded >= 2
        snap = dw.program(R.PROGRAM).snapshot()
        assert str((kernel, 1 << 9)) in snap["signatures"]
        for fill in (0x33, 0x44):
            hdr = bytes([fill]) * 80
            assert rs.sweep(hdr, EASY, max_nonces=1 << 13)[0] == \
                jsweep_cpu(hdr, EASY, max_nonces=1 << 13)[0]
        after = dw.program(R.PROGRAM).snapshot()
        assert rs.buffer_swaps == 4
        assert after["shapes"] == snap["shapes"]
        assert after["retraces_unexpected"] == snap["retraces_unexpected"]
        keys = set(rs.snapshot())
        assert {"template_generation", "buffer_swaps", "rollover_passes",
                "stale_hits", "segments_discarded"} <= keys
    finally:
        rs.close()


def test_resident_rollover_wrap_hit():
    rs = R.ResidentSweep(tile=1 << 9, seg_tiles=2, inflight=2, kernel="h7")
    try:
        header = b"\xab" * 80
        start = (1 << 32) - (1 << 10)
        n, _ = rs.sweep(header, EASY, start_nonce=start, max_nonces=1 << 13)
        expect = next(
            (start + i) & 0xFFFFFFFF for i in range(1 << 13)
            if int.from_bytes(sha256d(header[:76] + ((start + i) & 0xFFFFFFFF)
                                      .to_bytes(4, "little")), "little")
            <= EASY)
        assert n == expect and rs.passes >= 1
    finally:
        rs.close()


def test_resident_advance_resumes_past_false_positive():
    header = b"\x66" * 80
    target = 1 << 250
    real = [n for n in range(1 << 11)
            if int.from_bytes(sha256d(header[:76] + n.to_bytes(4, "little")),
                              "little") <= target]
    rs = R.ResidentSweep(tile=1 << 10, seg_tiles=2, inflight=1, kernel="h7")
    try:
        true_confirm = rs._confirm
        rejected = []

        def confirm(nonce):
            if nonce == real[0] and not rejected:
                rejected.append(nonce)
                return False
            return true_confirm(nonce)

        rs._confirm = confirm
        rs.set_template(header, target)
        parked = rs.advance(1 << 11)
        got = [h["nonce"] for h in rs.take_hits()]
        assert rejected and rs.false_positives >= 1
        assert real[0] not in got and real[1] in got and parked == len(got)
    finally:
        rs.close()


# ---- supervision ------------------------------------------------------------

def _broken_entries(monkeypatch, error):
    def broken(*_a, **_k):
        raise error

    for mod, name in ((MI, "sweep"), (SW, "sweep_fast"), (R, "sweep"),
                      (R, "sweep_fast"), (PS, "pallas_sweep")):
        monkeypatch.setattr(mod, name, broken)


@pytest.mark.parametrize("engine", ["exact", "resident-exact"])
@pytest.mark.parametrize("error", [
    cuda_build.KernelUnavailable("nvcc failed"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    ValueError("bad sweep shape")])
def test_broken_sweep_kernel_raises_through_generate_blocks(
        monkeypatch, engine, error):
    """A sweep kernel that cannot be built, faults on the card, runs out
    of memory or is called wrongly raises out of generate_blocks; the
    scalar CPU loop never serves the block."""
    _broken_entries(monkeypatch, error)
    sweep = (None if engine == "exact" else dispatch.supervised_resident_sweep(
        R.ResidentSweep(tile=TILE, seg_tiles=2, kernel="exact")))
    cs = _port_chain()
    with pytest.raises(cuda_build.KernelUnavailable):
        generate_blocks(cs, SPK, 1, tile=TILE, sweep=sweep)
    assert cs.tip().height == 0
    assert dispatch.breaker("miner").snapshot()["fallback_calls"] == 0


def test_wrong_nonce_from_the_kernel_raises_through_generate_blocks(
        monkeypatch):
    """An exact kernel whose compare is inverted claims the first nonce
    ABOVE the target: the host re-check rejects it, and since no fault was
    injected the call raises instead of serving the scalar loop."""
    def inverted(tmpl, tgt, start, n_tiles, tile=MI.DEFAULT_TILE):
        limbs = list((tgt.to(torch.int64) & SW.M32).unbind())
        return SW.sweep_plain(
            tmpl, start, n_tiles, tile, lambda pre, n: ~MI.le256(
                MI.digest_to_limbs(SW.sweep_digest_hoisted(pre, n)), limbs))

    monkeypatch.setattr(MI, "sweep", inverted)
    cs = _port_chain()
    with pytest.raises(cuda_build.KernelUnavailable,
                       match="PoisonedOutput"):
        generate_blocks(cs, SPK, 1, tile=TILE)
    assert cs.tip().height == 0
    assert dispatch.breaker("miner").snapshot()["fallback_calls"] == 0


def test_open_breaker_without_an_injected_fault_raises():
    """The miner breaker opens only under injected faults; once they are
    disarmed, an open breaker raises rather than serving the scalar loop."""
    br = dispatch.breaker("miner")
    for _ in range(br.cfg.threshold):
        br.record_failure(faults.InjectedFault("drill"))
    assert br.state == dispatch.OPEN
    with pytest.raises(cuda_build.KernelUnavailable, match="breaker is open"):
        dispatch.supervised_sweep()(b"\xab" * 80, EASY, max_nonces=1 << 12)
    assert br.fallback_calls == 0


def test_cuda_without_a_card_raises_through_generate_blocks():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    cuda_build.set_device("cuda")
    with pytest.raises(cuda_build.KernelUnavailable):
        generate_blocks(_port_chain(), SPK, 1, tile=TILE)
    assert dispatch.breaker("miner").snapshot()["fallback_calls"] == 0


@pytest.mark.parametrize("mode", ["fail-always", "poison-output"])
@pytest.mark.parametrize("resident", [False, True])
def test_injected_fault_takes_the_scalar_loop(monkeypatch, resident, mode):
    """The reference's drills: fail-always at the miner site, or a claimed
    nonce the harness poisoned (caught by the host re-check), degrades to
    the scalar host sweep with an identical hit."""
    monkeypatch.setenv("BCP_FAULT_MODE", mode)
    monkeypatch.setenv("BCP_FAULT_OPS", "miner")
    faults.INJECTOR.reload()
    rs = R.ResidentSweep(tile=1 << 9, seg_tiles=2, kernel="exact")
    sweep = (dispatch.supervised_resident_sweep(rs) if resident
             else dispatch.supervised_sweep())
    header = b"\xab" * 80
    n, _ = sweep(header, EASY, max_nonces=1 << 12)
    assert n == jsweep_cpu(header, EASY, max_nonces=1 << 12)[0]
    assert dispatch.breaker("miner").fallback_calls >= 1
    assert rs.polls == (0 if mode == "fail-always" or not resident else 2)
