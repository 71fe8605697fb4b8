"""Proof-of-work rules.

Reference: src/pow.cpp:~13 (GetNextWorkRequired), :~50
(CalculateNextWorkRequired), :~74 (CheckProofOfWork);
src/arith_uint256.cpp:~190 (arith_uint256::SetCompact / GetCompact).

Python ints replace arith_uint256 (exact 256-bit arithmetic is native here —
no limb code needed on the host; the on-chip target compare in the miner
kernel uses 8×u32 limbs, see ops/sha256.py).

The BCH-family lineage adds EDA / cw-144 DAA difficulty rules
[fork-delta, hedged — SURVEY.md §0]; those are gated behind
Consensus params flags and implemented as ``get_next_work_required_cash``.
"""

from __future__ import annotations

# ---- compact bits ("nBits") codec — arith_uint256::SetCompact/GetCompact ----

def compact_to_target(bits: int) -> tuple[int, bool]:
    """Decode compact bits to a 256-bit target.

    Returns (target, overflow_or_negative). Mirrors SetCompact's fNegative /
    fOverflow outputs: consensus treats negative, zero, or overflowing targets
    as invalid PoW.
    """
    size = bits >> 24
    word = bits & 0x007FFFFF
    if size <= 3:
        target = word >> (8 * (3 - size))
    else:
        target = word << (8 * (size - 3))
    negative = word != 0 and (bits & 0x00800000) != 0
    overflow = word != 0 and (
        size > 34 or (word > 0xFF and size > 33) or (word > 0xFFFF and size > 32)
    )
    return target, (negative or overflow)


def target_to_compact(target: int) -> int:
    """Encode a 256-bit target as compact bits — arith_uint256::GetCompact."""
    if target == 0:
        return 0
    size = (target.bit_length() + 7) // 8
    if size <= 3:
        word = target << (8 * (3 - size))
    else:
        word = target >> (8 * (size - 3))
    # Avoid setting the sign bit: shift mantissa right, bump exponent.
    if word & 0x00800000:
        word >>= 8
        size += 1
    return (size << 24) | word


def check_proof_of_work(block_hash: bytes, bits: int, params) -> bool:
    """CheckProofOfWork (src/pow.cpp:~74): hash (as LE uint256) <= target,
    target in (0, pow_limit]."""
    target, bad = compact_to_target(bits)
    if bad or target == 0 or target > params.pow_limit:
        return False
    return int.from_bytes(block_hash, "little") <= target


def check_headers_pow_batch(headers80: list, params) -> list[bool]:
    """Batched CheckProofOfWork over serialized 80-byte headers — the
    headers-first sync pre-filter (p2p/connman._msg_headers): one
    supervised device dispatch hashes the whole announcement batch
    (ops/sha256.sha256d_headers rides the sha256 circuit breaker, so a
    dead backend degrades to per-header host hashing), then each digest is
    compared to its own header's decoded target on host. Verdicts are
    bit-identical to per-header check_proof_of_work by construction:
    target decoding and the <= compare are this module's scalar code."""
    import numpy as np

    from ..ops.sha256 import sha256d_headers

    if not headers80:
        return []
    arr = np.frombuffer(b"".join(headers80), dtype=np.uint8).reshape(-1, 80)
    n = arr.shape[0]
    # pad to a pow2 bucket (min 16) so the jit compiles O(log n) distinct
    # shapes across all announcement sizes, not one per batch length
    bucket = max(16, 1 << (n - 1).bit_length())
    if bucket != n:
        arr = np.concatenate([arr, np.repeat(arr[:1], bucket - n, axis=0)])
    digests = sha256d_headers(arr)
    from ..crypto.hashes import sha256d

    out = []
    for i, raw in enumerate(headers80):
        bits = int.from_bytes(raw[72:76], "little")
        target, bad = compact_to_target(bits)
        ok = (
            not bad and 0 < target <= params.pow_limit
            and int.from_bytes(digests[i].tobytes(), "little") <= target
        )
        if not ok and not bad and 0 < target <= params.pow_limit:
            # every FAILING verdict is host-confirmed before it is
            # returned: the batch's lane-0 spot check can miss a single
            # corrupted device lane, and callers punish peers on a False
            # here — a lying device must not be able to stall headers
            # sync by framing honest announcements (cheap: honest
            # traffic almost never takes this branch)
            ok = int.from_bytes(sha256d(raw), "little") <= target
        out.append(ok)
    return out


def get_block_proof(bits: int) -> int:
    """Chain-work contribution of a block — GetBlockProof
    (src/chain.cpp:~120): floor(2^256 / (target+1))."""
    target, bad = compact_to_target(bits)
    if bad or target == 0:
        return 0
    return (1 << 256) // (target + 1)


# ---- difficulty adjustment ----

def get_next_work_required(prev_index, new_block_time: int, params) -> int:
    """GetNextWorkRequired (src/pow.cpp:~13) — Core-lineage 2016-block rule.

    prev_index is the CBlockIndex of the tip the new block builds on (None at
    genesis). Testnet min-difficulty and regtest no-retarget behaviors match
    the reference.
    """
    pow_limit_bits = target_to_compact(params.pow_limit)
    if prev_index is None:
        return pow_limit_bits
    # NB: fPowNoRetargeting is honored inside CalculateNextWorkRequired (as in
    # the reference) so the min-difficulty special cases below still apply on
    # regtest/testnet chains.

    height = prev_index.height + 1
    # BCH-lineage routing [fork-delta, hedged]: with use_cash_daa set,
    # cw-144 DAA from daa_height and the EDA overlay before it. The
    # cash rules deliberately do NOT short-circuit on pow_no_retargeting:
    # -cashdaa on regtest is the fork-storm harness knob and must run the
    # same rule code every node will agree on (on a min-difficulty chain
    # both rules clamp at/near pow_limit, so mining stays trivial).
    if params.use_cash_daa and height >= params.daa_height >= 0:
        return get_next_work_required_cash(prev_index, new_block_time, params)
    interval = params.difficulty_adjustment_interval
    if height % interval != 0:
        if params.use_cash_daa:
            # EDA era (BCH-lineage): on min-difficulty chains the
            # 20-minute exception answers first, and otherwise the rule
            # anchors on the last REAL-difficulty block (the same
            # walk-back as the Core branch below — without it one
            # min-difficulty block would floor the whole interval at
            # pow_limit, diverging from reference nodes); then the
            # 12h-MTP-gap emergency adjustment, which clamps at
            # pow_limit so all-min chains keep their bits while still
            # RUNNING the rule every node must agree on
            anchor = prev_index
            if params.pow_allow_min_difficulty_blocks:
                if (new_block_time
                        > prev_index.time + params.pow_target_spacing * 2):
                    return pow_limit_bits
                while (anchor.prev is not None
                       and anchor.height % interval != 0
                       and anchor.bits == pow_limit_bits):
                    anchor = anchor.prev
            return eda_bits(anchor, params)
        if params.pow_allow_min_difficulty_blocks:
            # Testnet special-case: 20-minute gap → min difficulty; otherwise
            # walk back to the last non-min-difficulty block.
            if new_block_time > prev_index.time + params.pow_target_spacing * 2:
                return pow_limit_bits
            idx = prev_index
            while (
                idx.prev is not None
                and idx.height % interval != 0
                and idx.bits == pow_limit_bits
            ):
                idx = idx.prev
            return idx.bits
        return prev_index.bits

    # Retarget height. fPowNoRetargeting short-circuits in the reference's
    # CalculateNextWorkRequired before first_block_time is used; checking it
    # here avoids the (irrelevant) 2016-ancestor walk.
    if params.pow_no_retargeting:
        return prev_index.bits
    first = prev_index.get_ancestor(height - interval)
    assert first is not None
    return calculate_next_work_required(prev_index, first.time, params)


def calculate_next_work_required(prev_index, first_block_time: int, params) -> int:
    """CalculateNextWorkRequired (src/pow.cpp:~50) with the reference's
    4x clamp and integer order of operations."""
    if params.pow_no_retargeting:
        return prev_index.bits

    timespan = prev_index.time - first_block_time
    min_ts = params.pow_target_timespan // 4
    max_ts = params.pow_target_timespan * 4
    timespan = max(min_ts, min(max_ts, timespan))

    target, _ = compact_to_target(prev_index.bits)
    # Reference order: bnNew *= nActualTimespan; bnNew /= nPowTargetTimespan
    target = target * timespan // params.pow_target_timespan
    if target > params.pow_limit:
        target = params.pow_limit
    return target_to_compact(target)


# ---- BCH-family difficulty [fork-delta, hedged] ----

def eda_bits(prev_index, params) -> int:
    """Emergency Difficulty Adjustment (BCH-lineage pow.cpp, the Aug-2017
    pre-DAA rule): on a non-retarget height, if the median-time-past gap
    across the last six blocks exceeds 12 hours, the target grows by 25%
    (difficulty drops 20%), clamped at pow_limit. Otherwise the previous
    bits carry forward. Only reachable when params.use_cash_daa and the
    height is below daa_height."""
    if prev_index.height < 6:
        return prev_index.bits
    anc = prev_index.get_ancestor(prev_index.height - 6)
    if anc is None:
        return prev_index.bits
    mtp_gap = prev_index.get_median_time_past() - anc.get_median_time_past()
    if mtp_gap <= 12 * 3600:
        return prev_index.bits
    target, _ = compact_to_target(prev_index.bits)
    target += target >> 2  # +25% target = -20% difficulty
    if target > params.pow_limit:
        target = params.pow_limit
    return target_to_compact(target)


def get_next_work_required_cash(prev_index, new_block_time: int, params) -> int:
    """cw-144 DAA (simplified median-past form) used by BCH-family forks after
    their DAA activation height; EDA before it. Only active when
    params.use_cash_daa — OFF for the Bitcoin-compatible default chains so the
    mainnet genesis/retarget tests stay exact. [fork-delta, hedged]
    """
    pow_limit_bits = target_to_compact(params.pow_limit)
    if prev_index is None or prev_index.height < 144 + 2:
        return pow_limit_bits if prev_index is None else prev_index.bits

    def suitable(idx):
        # median-of-three by timestamp — exact GetSuitableBlock sorting
        # network (BCH-lineage pow.cpp); tie-handling must match, so no
        # stable sort here.
        b = [idx.prev.prev, idx.prev, idx]
        if b[0].time > b[2].time:
            b[0], b[2] = b[2], b[0]
        if b[0].time > b[1].time:
            b[0], b[1] = b[1], b[0]
        if b[1].time > b[2].time:
            b[1], b[2] = b[2], b[1]
        return b[1]

    last = suitable(prev_index)
    first = suitable(prev_index.get_ancestor(prev_index.height - 144))
    timespan = last.time - first.time
    timespan = max(72 * params.pow_target_spacing, min(288 * params.pow_target_spacing, timespan))

    work = last.chain_work - first.chain_work
    work = work * params.pow_target_spacing // timespan
    if work == 0:
        return pow_limit_bits
    target = (1 << 256) // work - 1
    if target > params.pow_limit:
        target = params.pow_limit
    return target_to_compact(target)
