"""The Schnorr path of the port at small size: a regtest chain whose dense
spends carry 65-byte Schnorr signatures (workload/sigchain.generate with
schnorr=True; the runway and fan-out stay ECDSA), validated by the port
under -ecdsakernel=msm (the plain MSM standing in for csrc/msm.cu, the
plain GLV verify for the ECDSA lanes, because the tensors lie on the CPU)
and by the JAX package's ChainstateManager on its CPU engine: the same
best block and coin digest, the tampered Schnorr block rejected by both
with the same reason, and MSM dispatches counted. The generator's signer
is held equal to the oracle's schnorr_sign."""

import random

import pytest
import torch

from bitcoincashplus_tpu.consensus.block import CBlock as JBlock
from bitcoincashplus_tpu.consensus.params import regtest_params as jparams
from bitcoincashplus_tpu.crypto import secp256k1 as joracle
from bitcoincashplus_tpu.store.blockstore import MemoryBlockStore as JMemStore
from bitcoincashplus_tpu.validation.chain import BlockStatus as JStatus
from bitcoincashplus_tpu.validation.chainstate import (
    BlockValidationError as JBlockValidationError,
)
from bitcoincashplus_tpu.validation.chainstate import (
    ChainstateManager as JChainstate,
)
from bitcoincashplus_tpu.validation.coins import MemoryCoinsView as JMemView
from bitcoincashplus_tpu.validation.scriptcheck import (
    BlockScriptVerifier as JVerifier,
)
from bitcoincashplus_tpu_torch.consensus.block import CBlock
from bitcoincashplus_tpu_torch.ops import cuda_build, dispatch
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
from bitcoincashplus_tpu_torch.validation.chain import BlockStatus
from bitcoincashplus_tpu_torch.validation.chainstate import (
    BlockValidationError,
)
from bitcoincashplus_tpu_torch.workload import sigchain


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """24 Schnorr inputs in 4 dense blocks, and two 4-input Schnorr tips."""
    d = str(tmp_path_factory.mktemp("schnorr_chain"))
    summary = sigchain.generate(d, 24, inputs_per_tx=3, txs_per_block=2,
                                fan_k=30, tip_inputs=4, schnorr=True)
    return d, summary


@pytest.fixture
def cpu_device(monkeypatch):
    for k in ("BCP_FAULT_MODE", "BCP_FAULT_OPS", "BCP_ECDSA_KERNEL"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BCP_MSM_SEED", "0x5eed")
    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    monkeypatch.setattr(E, "_KERNEL", None)
    E.set_device("cpu")
    E.STATS.__init__()
    dispatch.reset()


def test_the_signer_is_the_oracles_schnorr_sign():
    rng = random.Random(5)
    for secret in (sigchain.KEY_SECRET, 1, joracle.N - 1):
        signer = sigchain.SchnorrSigner(secret)
        assert signer.pub == joracle.point_mul(secret, joracle.G)
        for _ in range(2):
            e = rng.randrange(joracle.N)
            assert signer.sign(e) == joracle.schnorr_sign(secret, e)


def test_the_chain_carries_schnorr_signatures(chain):
    datadir, gen = chain
    recs = sigchain.chain_sig_records(datadir, 10 ** 6)
    algos = [r.algo for r in recs]
    assert algos.count("schnorr") == gen["sigs"] == 24
    assert set(algos) == {"ecdsa", "schnorr"}  # the fan-out stays ECDSA
    tampered = CBlock.from_bytes(gen["tampered_tip"])
    assert all(len(txin.script_sig) == 1 + 65 + 1 + 33
               for tx in tampered.vtx[1:] for txin in tx.vin)


def _reason(fn):
    try:
        fn()
    except (BlockValidationError, JBlockValidationError) as e:
        return e.reason
    return None


def test_port_msm_and_jax_cpu_engine_agree_on_the_schnorr_chain(
        chain, cpu_device):
    datadir, gen = chain
    cs, dev = sigchain.validate_chain(datadir, "device", kernel="msm",
                                      depth=8)
    st = E.STATS
    assert st.schnorr_sigs == 24 and st.msm_batches_accepted >= 1
    assert st.msm_dispatches >= 3  # two canaries and the batch
    assert st.glv_dev_dispatches >= 1  # the fan-out's ECDSA lanes
    assert st.cpu_fallback_sigs == 0 and st.fault_fallback_sigs == 0
    assert st.msm_fallback_sigs == 0 and st.schnorr_cpu_sigs == 0

    params = jparams()
    jcs = JChainstate(params, JMemView(), JMemStore(),
                      script_verifier=JVerifier(params, backend="cpu"))
    for block in sigchain.read_blocks(datadir):
        jcs.process_new_block(JBlock.from_bytes(block.serialize()))
    assert dev["height"] == jcs.tip().height == gen["tip_height"]
    assert bytes.fromhex(dev["best"]) == jcs.tip().hash
    assert dev["digest"] == sigchain.coin_digest(jcs)

    # the tampered tip: the same reason from both, then rejected by both;
    # the good tip accepted by both, the coin sets still equal
    raw = gen["tampered_tip"]
    reason = _reason(lambda: cs.test_block_validity(CBlock.from_bytes(raw)))
    assert reason is not None
    assert reason == _reason(
        lambda: jcs.test_block_validity(JBlock.from_bytes(raw)))
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
    assert st.cpu_fallback_sigs == 0 and st.msm_fallback_sigs == 0
