"""Transaction storms — the port's live-traffic workload: mempool
admission through the signature service (serving/sigservice.SigService).

Two shapes of the same load:

- ``records(n, seed)``: fresh signature checks as the accept path defers
  them (SigCheckRecords), from a pool of 16 keys with a fresh message for
  each record, so that the service's in-flight dedup never collapses the
  work (the shape of the reference's serving levels, bench.py's
  ``_bench_serving_levels``). ECDSA records are signed with the native
  signer (the Python oracle where the native library is absent); with
  ``schnorr=True`` each key signs as workload/sigchain.SchnorrSigner, the
  BCH Schnorr signature the MSM batch check verifies.
- ``storm(outputs)``: signed transactions spending the outputs of
  workload/sigchain.generate's chain, which pay KEY_SECRET's P2PKH
  (``spendable(datadir)`` finds those still unspent: the fan-out's
  leftovers). The unit of work is a 2-input P2PKH transaction; parent ->
  child chains (a child spends both of its parent's outputs: one
  ancestor, well inside the ancestor limit), one transaction whose
  signature is altered inside its s (workload/sigchain._tamper_input: it
  can only fail at signature verification), and a Schnorr-signed set
  (workload/sigchain.sign_schnorr_p2pkh). ``first`` holds the independent
  transactions' first half and the parents, ``second`` the rest and the
  children: fed in that order, every input exists when its spender
  arrives, however many threads feed a wave.
"""

from __future__ import annotations

import random

from ..consensus.tx import COutPoint, CTransaction, CTxIn, CTxOut
from ..crypto import secp256k1 as oracle
from ..script.interpreter import SigCheckRecord
from ..wallet.keys import CKey
from ..wallet.signing import sign_transaction
from . import sigchain

KEY_POOL = 16
_KEYS: dict = {}
_CHAIN_KEY: list = []


def _key_pool(seed: int) -> list:
    """KEY_POOL (secret, public point) pairs drawn from ``seed`` (kept: a
    public key costs a point multiplication)."""
    if seed not in _KEYS:
        rng = random.Random(seed)
        secrets = [rng.randrange(1, oracle.N) for _ in range(KEY_POOL)]
        _KEYS[seed] = [(d, oracle.point_mul(d, oracle.G)) for d in secrets]
    return _KEYS[seed]


def records(n: int, seed: int, schnorr: bool = False,
            bad_every: int = 0) -> list:
    """``n`` fresh SigCheckRecords: record i signed by key i % 16 of the
    seed's pool over a fresh random message. ``bad_every`` > 0 makes every
    bad_every-th record (i % bad_every == bad_every - 1) check a message one
    above the signed one: a verdict of False."""
    from .. import native

    keys = _key_pool(seed)
    rng = random.Random(seed ^ 0x5EED)
    if schnorr:
        signers = [sigchain.SchnorrSigner(d) for d, _ in keys]
    sign = native.ecdsa_sign if native.available() else oracle.ecdsa_sign
    out = []
    for i in range(n):
        d, pub = keys[i % KEY_POOL]
        e = rng.randrange(oracle.N)
        r, s = signers[i % KEY_POOL].sign(e) if schnorr else sign(d, e)
        if bad_every and i % bad_every == bad_every - 1:
            e = (e + 1) % oracle.N
        out.append(SigCheckRecord(pub, r, s, e,
                                  algo="schnorr" if schnorr else "ecdsa"))
    return out


# ---- transactions over a sigchain chain ----------------------------------

def chain_key() -> CKey:
    """The key every output of workload/sigchain.generate's chain pays
    (made once: its public key costs a point multiplication)."""
    if not _CHAIN_KEY:
        _CHAIN_KEY.append(CKey(sigchain.KEY_SECRET, compressed=True))
    return _CHAIN_KEY[0]


def spendable(datadir: str) -> list:
    """The unspent non-coinbase outputs of the chain stored in ``datadir``
    that pay chain_key()'s P2PKH, in chain order: [(COutPoint, value)]."""
    spk = chain_key().p2pkh_script()
    outs: dict = {}
    for block in sigchain.read_blocks(datadir):
        for tx in block.vtx:
            for txin in tx.vin:
                outs.pop((txin.prevout.hash, txin.prevout.n), None)
            if tx.is_coinbase():
                continue
            for n, out in enumerate(tx.vout):
                if out.script_pubkey == spk:
                    outs[(tx.txid, n)] = out.value
    return [(COutPoint(txid, n), value) for (txid, n), value in outs.items()]


def spend(inputs: list, n_out: int = 2, schnorr: bool = False,
          signer=None) -> CTransaction:
    """A signed transaction spending ``inputs`` ([(COutPoint, value)], each
    paying chain_key()'s P2PKH) into ``n_out`` equal outputs to the same
    script, less sigchain.FEE: ECDSA (forkid) signatures, or with
    ``schnorr`` 65-byte Schnorr ones (``signer``: a SchnorrSigner of
    KEY_SECRET, made here when None)."""
    key = chain_key()
    spk = key.p2pkh_script()
    total = sum(v for _, v in inputs)
    per = (total - sigchain.FEE) // n_out
    unsigned = CTransaction(
        version=1,
        vin=tuple(CTxIn(op, b"", 0xFFFFFFFE) for op, _ in inputs),
        vout=tuple(CTxOut(per, spk) for _ in range(n_out)))
    if schnorr:
        return sigchain.sign_schnorr_p2pkh(
            unsigned, [v for _, v in inputs], key,
            signer or sigchain.SchnorrSigner(sigchain.KEY_SECRET))
    return sign_transaction(
        unsigned, [(spk, v) for _, v in inputs],
        lambda ident: key if ident in (key.pubkey_hash, key.pubkey)
        else None, enable_forkid=True)


def outputs_of(tx: CTransaction) -> list:
    return [(COutPoint(tx.txid, n), out.value)
            for n, out in enumerate(tx.vout)]


def storm(outputs: list, n_chains: int, n_schnorr: int,
          seed: int = 0) -> dict:
    """The storm over ``outputs`` ([(COutPoint, value)], two a
    transaction): ``n_chains`` parent -> child chains, ``n_schnorr``
    Schnorr-signed transactions, one tampered transaction, and the rest
    independent 2-input transactions; the order of the outputs is shuffled
    by ``seed``. Returns {"first": [...], "second": [...], "tampered": tx,
    "schnorr": [...]} (module docstring)."""
    outs = list(outputs)
    random.Random(seed).shuffle(outs)
    pairs = [outs[i:i + 2] for i in range(0, len(outs) - 1, 2)]
    need = n_chains + n_schnorr + 1
    if len(pairs) < need:
        raise ValueError(f"{len(outs)} outputs: the storm needs at least "
                         f"{2 * need}")
    tampered = spend(pairs.pop())
    tampered = sigchain._tamper_input(tampered, len(tampered.vin) // 2)
    signer = sigchain.SchnorrSigner(sigchain.KEY_SECRET)
    schnorr = [spend(pairs.pop(), schnorr=True, signer=signer)
               for _ in range(n_schnorr)]
    parents = [spend(pairs.pop()) for _ in range(n_chains)]
    children = [spend(outputs_of(p)) for p in parents]
    independent = [spend(p) for p in pairs]
    half = len(independent) // 2
    return {"first": independent[:half] + parents,
            "second": independent[half:] + children,
            "tampered": tampered, "schnorr": schnorr}


def storm_chain(datadir: str) -> dict:
    """A chain for the storm: workload/sigchain.generate with one signature
    a dense transaction and two dense transactions, so that the fan-out's
    2,000 outputs are left but for the two the dense block spends."""
    return sigchain.generate(datadir, total_sigs=2, inputs_per_tx=1,
                             tip_inputs=1)
