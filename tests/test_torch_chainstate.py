"""The block-validation slice of the port at small size: a signature chain
from the port's generator, validated by the port (pipelined, plain w4 on
the CPU device) and by the JAX package's ChainstateManager (CPU engine) —
same coin digest, same best block, the tampered tip rejected by both —
and a datadir written by the JAX package, opened and continued by the
port's store."""

import os

import pytest
import torch

from bitcoincashplus_tpu.consensus.block import CBlock as JBlock
from bitcoincashplus_tpu.consensus.params import regtest_params as jparams
from bitcoincashplus_tpu.store.blockstore import BlockStore as JBlockStore
from bitcoincashplus_tpu.store.blockstore import MemoryBlockStore as JMemStore
from bitcoincashplus_tpu.store.chainstatedb import BlockIndexDB as JIndexDB
from bitcoincashplus_tpu.store.chainstatedb import CoinsDB as JCoinsDB
from bitcoincashplus_tpu.store.kvstore import KVStore as JKVStore
from bitcoincashplus_tpu.validation.chain import BlockStatus as JStatus
from bitcoincashplus_tpu.validation.chainstate import (
    ChainstateManager as JChainstate,
)
from bitcoincashplus_tpu.validation.coins import MemoryCoinsView as JMemView
from bitcoincashplus_tpu.validation.scriptcheck import (
    BlockScriptVerifier as JVerifier,
)
from bitcoincashplus_tpu_torch.consensus.block import CBlock
from bitcoincashplus_tpu_torch.consensus.params import regtest_params
from bitcoincashplus_tpu_torch.consensus.pow import compact_to_target
from bitcoincashplus_tpu_torch.ops import cuda_build, dispatch
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
from bitcoincashplus_tpu_torch.ops import secp256k1 as S
from bitcoincashplus_tpu_torch.store.blockstore import BlockStore
from bitcoincashplus_tpu_torch.store.chainstatedb import BlockIndexDB, CoinsDB
from bitcoincashplus_tpu_torch.store.kvstore import KVStore
from bitcoincashplus_tpu_torch.validation.chain import BlockStatus
from bitcoincashplus_tpu_torch.validation.chainstate import ChainstateManager
from bitcoincashplus_tpu_torch.wallet.keys import CKey
from bitcoincashplus_tpu_torch.workload import sigchain


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain verify's tensors are small, and the
    suite runs in several worker processes at once — a thread pool per
    worker only oversubscribes the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sigchain"))
    summary = sigchain.generate(d, 200, inputs_per_tx=20, txs_per_block=5,
                                fan_k=100, tip_inputs=4)
    return d, summary


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    E.set_device("cpu")
    E.STATS.__init__()
    dispatch.reset()


def _jax_validate(datadir):
    """The JAX package's ChainstateManager, CPU engine, same block order."""
    params = jparams()
    cs = JChainstate(params, JMemView(), JMemStore(),
                     script_verifier=JVerifier(params, backend="cpu"))
    for block in sigchain.read_blocks(datadir):
        cs.process_new_block(JBlock.from_bytes(block.serialize()))
    return cs


def test_port_and_jax_agree_on_the_chain(chain, cpu_device):
    datadir, gen = chain
    assert gen["sigs"] == 200
    cs, dev = sigchain.validate_chain(datadir, "device", kernel="w4", depth=8)
    assert E.STATS.sigs_verified == 202 and E.STATS.cpu_fallback_sigs == 0
    jcs = _jax_validate(datadir)
    assert dev["height"] == jcs.tip().height == gen["tip_height"]
    assert bytes.fromhex(dev["best"]) == jcs.tip().hash
    assert dev["digest"] == sigchain.coin_digest(jcs)

    # the tampered tip is rejected by both; the good tip accepted by both,
    # and the coin sets still agree byte for byte
    for key, rejected in (("tampered_tip", True), ("good_tip", False)):
        raw = gen[key]
        cs.process_new_block(CBlock.from_bytes(raw))
        jcs.process_new_block(JBlock.from_bytes(raw))
        idx = cs.block_index[CBlock.from_bytes(raw).get_hash()]
        jidx = jcs.block_index[JBlock.from_bytes(raw).get_hash()]
        assert bool(idx.status & BlockStatus.FAILED_VALID) is rejected
        assert bool(jidx.status & JStatus.FAILED_VALID) is rejected
    assert cs.tip().hash == jcs.tip().hash == \
        CBlock.from_bytes(gen["good_tip"]).get_hash()
    assert sigchain.coin_digest(cs) == sigchain.coin_digest(jcs)
    # the bad lane was a device False, confirmed on the host
    assert E.STATS.reject_confirm_sigs >= 1


def test_broken_kernel_surfaces_at_settle(chain, cpu_device, monkeypatch):
    """On a small chain the LanePacker's first dispatch is the tail flush
    inside a block's settle(): a kernel that cannot be built must raise
    out of the import loop there too, and no signature may be verified on
    the CPU in its place."""
    def broken(*_a):
        raise S.KernelUnavailable("nvcc failed")

    monkeypatch.setattr(S, "ecdsa_verify_batch_pallas_w4", broken)
    monkeypatch.setattr(S, "ecdsa_verify_batch_pallas_w4_bytes", broken)
    datadir, _gen = chain
    with pytest.raises(S.KernelUnavailable):
        sigchain.validate_chain(datadir, "device", kernel="w4", depth=8)
    assert E.STATS.fault_fallback_sigs == 0
    assert E.STATS.cpu_fallback_sigs == 0
    assert E.STATS.sigs_verified == 0
    assert dispatch.breaker("ecdsa").snapshot()["fallback_calls"] == 0


def test_cpu_engine_matches_device_path_digest(chain, cpu_device):
    datadir, _gen = chain
    _cs, cpu = sigchain.validate_chain(datadir, "cpu", depth=1)
    jcs = _jax_validate(datadir)
    assert cpu["digest"] == sigchain.coin_digest(jcs)
    assert E.STATS.dispatches == 0


def test_chain_sig_records_are_the_chains_signatures(chain):
    from bitcoincashplus_tpu.ops import ecdsa_batch as jeb

    datadir, _gen = chain
    recs = sigchain.chain_sig_records(datadir, 50)
    assert len(recs) == 50
    assert jeb._verify_cpu(recs).all()


def test_port_store_continues_a_jax_written_datadir(tmp_path):
    """A datadir written by the JAX package (tools/gen_sigchain.py) opens
    in the port's store, the port extends it by one block, and the JAX
    package reads the result back."""
    from tools import gen_sigchain

    d = str(tmp_path)
    js = gen_sigchain.generate(d, 40, inputs_per_tx=10, txs_per_block=2,
                               fan_k=20)
    net = os.path.join(d, "regtest")
    params = regtest_params()

    def port_open():
        idx_kv = KVStore(os.path.join(net, "blocks", "index.sqlite"))
        coins_kv = KVStore(os.path.join(net, "chainstate.sqlite"))
        store = BlockStore(net, params.netmagic)
        cs = ChainstateManager(params, CoinsDB(coins_kv), store,
                               script_verifier=None,
                               index_db=BlockIndexDB(idx_kv))
        assert cs.load_block_index()
        return cs, (store, idx_kv, coins_kv)

    cs, handles = port_open()
    assert cs.tip().height == js["tip_height"]
    n_coins = cs.coins.base.count_coins()
    tip = cs.tip()
    target, _ = compact_to_target(params.genesis.header.bits)
    spk = CKey(sigchain.KEY_SECRET, compressed=True).p2pkh_script()
    blk = sigchain._make_block(tip.hash, tip.height + 1,
                               tip.header.time + 60,
                               params.genesis.header.bits, target, (), spk)
    cs.process_new_block(blk)
    cs.flush()
    for h in handles:
        h.close()

    jp = jparams()
    idx_kv = JKVStore(os.path.join(net, "blocks", "index.sqlite"))
    coins_kv = JKVStore(os.path.join(net, "chainstate.sqlite"))
    jstore = JBlockStore(net, jp.netmagic)
    jcs = JChainstate(jp, JCoinsDB(coins_kv), jstore, script_verifier=None,
                      index_db=JIndexDB(idx_kv))
    try:
        assert jcs.load_block_index()
        assert jcs.tip().hash == blk.get_hash()
        assert jcs.tip().height == js["tip_height"] + 1
        assert jcs.coins.base.count_coins() == n_coins + 1
        assert JBlock.from_bytes(jstore.get_block(blk.get_hash())) \
            .get_hash() == blk.get_hash()
    finally:
        for h in (jstore, idx_kv, coins_kv):
            h.close()
