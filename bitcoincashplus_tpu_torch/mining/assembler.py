"""Block template assembly.

Reference: src/miner.cpp:~130 (BlockAssembler::CreateNewBlock), :~440
(IncrementExtraNonce). Package selection over the mempool's ancestor-feerate
index (addPackageTxs :~300) plugs in via the `mempool` argument — with no
mempool the template is coinbase-only (enough for regtest generatetoaddress,
the reference behaves identically on an empty mempool).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field, replace
from typing import Optional

from ..consensus.block import CBlock, CBlockHeader
from ..consensus.merkle import block_merkle_root
from ..consensus.params import ChainParams, get_block_subsidy
from ..consensus.pow import get_next_work_required
from ..consensus.tx import COutPoint, CTransaction, CTxIn, CTxOut
from ..consensus.versionbits import compute_block_version
from ..util import telemetry as tm
from ..validation.chain import CBlockIndex
from ..validation.chainstate import ChainstateManager, _script_int

# ISSUE 20: getblocktemplate build-latency breakdown — "select" is the
# mempool package-selection leg (the batched frontier's hot path),
# "total" the whole CreateNewBlock including merkle root + the
# TestBlockValidity dry-run. Under a flood the select leg is the part
# the incremental frontier must keep flat.
_TEMPLATE_H = tm.histogram(
    "bcp_template_build_seconds",
    "CreateNewBlock wall-clock per template",
    labels=("stage",))


def template_build_quantiles() -> dict:
    """gettpuinfo.mempool's template view: p50/p99 (ms) per build stage."""
    out = {}
    for stage in ("select", "total"):
        h = _TEMPLATE_H.labels(stage=stage)
        out[stage] = {f"{k}_ms": round(v * 1e3, 3)
                      for k, v in h.quantiles((0.5, 0.99)).items()}
        out[stage]["count"] = h.count
    return out


def bip34_coinbase_script_sig(height: int, extranonce: int = 0) -> bytes:
    """Height push (BIP34) + extranonce push — the reference's
    IncrementExtraNonce writes CScript() << nHeight << CScriptNum(nExtraNonce)."""
    tail = _script_int(extranonce) if extranonce > 0 else b""
    sig = _script_int(height) + tail
    if len(sig) < 2:  # bad-cb-length lower bound
        sig += b"\x00"
    return sig


@dataclass
class BlockTemplate:
    """CBlockTemplate (src/miner.h): block + per-tx fees/sigops."""

    block: CBlock
    fees: list[int] = field(default_factory=list)
    height: int = 0
    target: int = 0


class BlockAssembler:
    """BlockAssembler (src/miner.cpp:~110)."""

    def __init__(self, chainstate: ChainstateManager, mempool=None,
                 versionbits_cache=None):
        self.chainstate = chainstate
        self.mempool = mempool
        self.params: ChainParams = chainstate.params
        # VersionBitsCache: without it every template re-walks all period
        # boundaries from genesis (O(height) per getblocktemplate)
        self.versionbits_cache = versionbits_cache

    def create_new_block(self, script_pubkey: bytes,
                         time_override: Optional[int] = None) -> BlockTemplate:
        """CreateNewBlock: coinbase + greedy package selection + a
        TestBlockValidity dry-run (the reference asserts its own template
        connects)."""
        # settle barrier: a template is a tip externalization — mining on
        # an unsettled speculative tip would select mempool txs the
        # speculative layer already spent (the mempool only learns of
        # them at settle), assembling an invalid child
        t0 = _time.monotonic()
        settle = getattr(self.chainstate, "settle_horizon", None)
        if settle is not None:
            settle()
        tip = self.chainstate.tip()
        assert tip is not None
        height = tip.height + 1
        consensus = self.params.consensus

        now = self.chainstate.get_time()
        block_time = max(tip.get_median_time_past() + 1, now)
        if time_override is not None:
            block_time = time_override
        bits = get_next_work_required(tip, block_time, consensus)

        txs: list[CTransaction] = []
        fees: list[int] = []
        total_fees = 0
        if self.mempool is not None:
            t_sel = _time.monotonic()
            selected = self.mempool.select_for_block(
                max_size=self.params.max_block_size - 1000,
                height=height,
                block_time=tip.get_median_time_past(),
            )
            _TEMPLATE_H.labels(stage="select").observe(
                _time.monotonic() - t_sel)
            for entry in selected:
                txs.append(entry.tx)
                fees.append(entry.base_fee)
                total_fees += entry.base_fee

        coinbase = CTransaction(
            version=1,
            vin=(CTxIn(COutPoint(), bip34_coinbase_script_sig(height), 0xFFFFFFFF),),
            vout=(CTxOut(total_fees + get_block_subsidy(height, consensus), script_pubkey),),
            locktime=0,
        )
        vtx = (coinbase, *txs)
        root, _ = block_merkle_root(_BlockView(vtx))
        # ComputeBlockVersion (miner.cpp:~60): signal every versionbits
        # deployment currently STARTED/LOCKED_IN on top of TOP_BITS
        version = compute_block_version(
            tip, consensus.deployments,
            consensus.miner_confirmation_window,
            consensus.rule_change_activation_threshold,
            self.versionbits_cache,
        )
        header = CBlockHeader(
            version=version,
            hash_prev_block=tip.hash,
            hash_merkle_root=root,
            time=block_time,
            bits=bits,
            nonce=0,
        )
        block = CBlock(header, vtx)
        from ..consensus.pow import compact_to_target

        target, _bad = compact_to_target(bits)
        tmpl = BlockTemplate(block=block, fees=[0, *fees], height=height, target=target)
        self._test_block_validity(tmpl)
        _TEMPLATE_H.labels(stage="total").observe(_time.monotonic() - t0)
        return tmpl

    def _test_block_validity(self, tmpl: BlockTemplate) -> None:
        """TestBlockValidity (src/validation.cpp:~3500): dry-run the
        non-PoW checks so a bad template never reaches the miner (shared
        with getblocktemplate's BIP22 proposal mode)."""
        self.chainstate.test_block_validity(tmpl.block)


class _BlockView:
    """Minimal duck-typed block for block_merkle_root before CBlock exists."""

    def __init__(self, vtx):
        self.vtx = vtx


def increment_extranonce(block: CBlock, height: int, extranonce: int) -> CBlock:
    """IncrementExtraNonce (src/miner.cpp:~440): bump the coinbase scriptSig
    extranonce and recompute the Merkle root. Returns a new block (immutables
    all the way down); the caller owns the extranonce counter."""
    coinbase = block.vtx[0]
    new_cb = CTransaction(
        version=coinbase.version,
        vin=(
            CTxIn(
                COutPoint(),
                bip34_coinbase_script_sig(height, extranonce),
                coinbase.vin[0].sequence,
            ),
        ),
        vout=coinbase.vout,
        locktime=coinbase.locktime,
    )
    vtx = (new_cb, *block.vtx[1:])
    root, _ = block_merkle_root(_BlockView(vtx))
    return CBlock(replace(block.header, hash_merkle_root=root), vtx)
