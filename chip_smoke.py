#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bitcoincashplus_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded   # phases 1 and 7a-7c alone, on every
                                      # card of a host with several
    python3 chip_smoke.py --msm-teams # msm_run at every bucket with the
                                      # walk and merges on teams of 2 and 4

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build   — compile each csrc/*.cu (w4_verify.cu, glv_verify.cu,
             glv_pair.cu, sha256d_sweep.cu, sha256d_batch.cu, msm.cu,
             ladder_verify.cu; the ECDSA kernels share
             csrc/secp256k1_core.cuh, the GLV pair csrc/glv_lane.cuh, the
             GLV lane and the MSM csrc/glv_split.cuh, the MSM and the
             ladder csrc/secp256k1_complete.cuh) by
             its own nvcc (sm_90a), all started together, from this
             checkout; print the build seconds, ptxas' registers, stack
             frame and spills per kernel, the w4 kernels' SASS local
             loads and stores (LDL / STL: the phase fails on any, or on a
             stack frame or spill), the GLV kernels' (the pair design's
             instances gated the same way, the carry-chain ones
             reported), the sweep kernels' SASS instruction counts
             (cuobjdump) beside the counts taken from their rounds, and
             the batch kernels' and the MSM kernels' (gated: no local
             memory), and the windowed ladder's (reported).
2. ecdsa   — the w4 field core alone (entry w4_field_selftest: fe_mul,
             fe_sqr, fe_add, fe_sub, fe_canon, the zero test and fe_eq on
             FIELD_EDGES x FIELD_EDGES and 4096 seeded random pairs)
             against Python ints, error 0; the GLV designs' products the
             same way (entry glv_field_chain: fe_mul, fe_sqr, the pair's
             split fe_mul_pair, fe_add), then timed as dependent chains at
             1 and 4 warps a scheduler. Then each ECDSA entry at
             B = 32, 128, 1024, 2048, 8192 and 16384 (the validation
             path's shapes among them) on seeded valid and invalid
             signatures, wrap lanes, q_inf lanes and crafted degenerate
             lanes, at every team size T and block size, held against its
             plain PyTorch version on the card (degen equal everywhere, ok
             equal on non-degen lanes) and the verdicts after the host
             re-check against the host oracle; one line per (shape, T)
             with the time at each block size, and the launch shape the
             wrapper's table (ops/secp256k1.ECDSA_LAUNCH) picks beside the
             fastest measured. The same for both GLV entries
             (glv_dev_verify on the w4 byte matrices, glv_verify on the
             host split) at B = 1024, 2048, 8192 and 16384, with
             GLV-degenerate lanes (glv_records) and the IMAD bound of
             glv_imad_count, at every team code of both designs
             (ops/secp256k1.GLV_TEAMS) and block size: GLV_LAUNCH's launch
             beside the fastest measured, beside the carry-chain design at
             w4's table (ECDSA_LAUNCH) timed in the same call, and the
             warps a scheduler of the launch.
2b. split  — the GLV split alone (glv_decompose_device_batch, entry
             glv_decompose) through its wrapper on GLV_EDGES and 4096
             seeded scalars (counts zeroed just before, read just after):
             every lane equal to the Python glv_decompose, the whole equal
             to the plain version; the wrapper's parts timed (the typed
             entry's lookup, its allocation beside the four it made
             before, the launch alone, the whole call, and the kernel's
             device time behind a spin).
2c. msm    — the Schnorr MSM (csrc/msm.cu, K9: the GLV split, the
             bucket walk, the merges, the bit-sum reduction, the window
             tree) at every bucket 64 .. 16384 on seeded terms of known
             discrete logs with a crafted corpus (P == Q and P == -Q in
             buckets and merges, zero and n - 1 scalars, flagged
             padding), its sum nonzero and zero, and on a sparse crafted
             corpus whose plain run must meet P == Q and P == -Q in the
             walk, a merge, the reduction and the window tree: the verdict
             entry and the partial entry's canonical Jacobian triple equal
             to the plain version, the affine sum and the verdict to the
             host's; device time of msm_run and of each launch kind (split,
             walk, merges, reduction, window tree), the plain version's
             wall, the IMAD bound (the fewer IMADs of this schedule and
             of the Horner schedule: 64 windows, suffix sums, a Horner
             pass) and the chain floor, each beside both schedules' on
             the same inputs.
2d. ladder — the windowed ladder (csrc/ladder_verify.cu, K8) through its
             wrapper ecdsa_verify_batch_jit at every plane bucket 32 ..
             16384 on pack_records' planes of seeded signatures with the
             crafted corpus (u1 = 0, Q = G, Q = -G, Q = G and Q = -G with
             u1 == u2, q_inf, wrap on and off, padding): every verdict
             equal to the plain version's lane for lane on the card and to
             the oracle; the entry timed by CUDA events, the plain
             version's wall, the IMAD bound and the chain floor, each
             beside the bit ladder's on the same data.
3. sweeps  — each sweep entry (sweep_h7 at tile 2^20 and at the resident
             loop's 2^16 x 8, sweep_h7_pallas at 64 x 128 lanes x 4096
             tiles, sweep_exact at tile 2^16) against its plain version:
             (found, nonce, tiles_done) exactly equal at 8 seeded starts
             with about one candidate a launch, a start straddling 2^32
             whose first candidate lies past the wrap, and a no-hit
             launch; kernel and plain times on the no-hit launch, GH/s,
             and the integer-operation bound. Then the exact and h7
             engines' own launch, the whole nonce space (2^16 x 65536 and
             2^20 x 4096 from nonce 0), against the plain version with its
             first candidate between 2^26 and 2^28, both timed on it; and
             that launch timed with no hit (no plain time: minutes).
3b. batch  — the batch SHA-256d kernels of csrc/sha256d_batch.cu (on
             csrc/sha256_core.cuh): one dependent sha256d_64's latency
             (entry sha256d_chain, equal to hashlib's chain) and one
             round's dependent path (entry sha256_round_path, equal to a
             Python model); sha256d_headers and check_headers_pow at
             B = 16, 17, 2048 and 16384 (lane 0 the mainnet genesis header;
             targets at and just below a digest, and difficulty 1);
             merkle_tree at buckets 128 to 2^16 (one launch each) with m
             the bucket, odd, bucket / 2 + 1, a duplicated tail (mutated),
             equal pairs past m (not mutated) and 2, and at 2^17 (two
             chained launches) with m the bucket, the duplicated tail and
             equal pairs past m; sha256d_pairs at 128, 512, 1000 and 2^16
             rows — each exactly equal to its plain version on the card
             and to the host oracles (hashlib, the compare,
             compute_merkle_root, merkle_root_naive), the tree's ticket
             counters left at 0; kernel and plain times (the tree's also
             with its ticket counter zeroed before each call, and through
             compute_merkle_root_tpu_ex), the bound (the largest of the
             operations over the card, the bytes, and the longest thread's
             rounds x one round's dependent path), this design's issue
             floor (the longest thread's instructions at one a clock) and
             the chain floor.
4. genesis — a known answer: the mainnet genesis header at target
             0x1d00ffff, a 2^28-nonce window ending at its nonce, swept by
             each entry's host loop: the same nonce, host-verified.
5. slice   — the block-validation main path at bench.py's reindex size:
             a 16,000-signature regtest chain from workload/sigchain.py,
             read back block by block through a ChainstateManager with
             BlockScriptVerifier(backend="device") at pipeline depth 8; a
             small good tip and a tampered tip (submitblock shape);
             dispatch_packed(backend="device") on 8190 of the chain's
             signatures (the native engine's slice width). Eight times,
             in the order of PATH_ORDER (glv w4 w4 glv, twice, so that
             neither kernel always runs first): under the default kernel
             (GLV: glv_dev_verify launched, no w4 entry, no fallback of
             any kind) and under -ecdsakernel=w4 (both w4 entries
             launched). Launch counts are zeroed just before and read
             just after each run, per entry and per shape; the blocking
             settle wait (E.STATS.device_seconds) and the GLV emit and
             enqueue times beside each wall, then each kernel's walls in
             run order and their median. The coin digest and best block
             must match the CPU engine's. Then the GLV ladder's injected
             drills on 200 signatures: fail-always at ecdsa_glv_dev
             launches glv_verify, at ecdsa_glv the w4 byte entry, with
             the same verdicts. Any shape a path launched that phase 2
             did not cover is then held against the plain version the
             same way.
5d. node   — the node's -reindex of the same chain (workload/sigchain
             .reindex: node/node.Node in process, -regtest -reindex),
             each run on a fresh copy of the datadir, counts zeroed just
             before and read just after: -tpu=0 (the CPU engine: the
             digest of record, no launch), the defaults (GLV:
             glv_dev_verify launched, no ladder) and BCP_SECP_PALLAS=0
             -ecdsakernel=w4 (the packed slices take the record route:
             ladder_verify launched, no w4 or GLV entry); each run's wall,
             sigs/s, engine, muhash, launches per kernel and fallback
             counters (cpu_fallback_sigs, fault_fallback_sigs, every
             breaker's fallback_calls: 0 on the device runs); height,
             best block and muhash equal to -tpu=0's.
5e. serving — the live-traffic path: mempool admission through the
             signature service (serving/sigservice.SigService, at the
             node's settings: 2,046 lanes, 4 ms deadline, 2 buffers,
             backend auto), on workload/txstorm's load, counts zeroed just
             before each run and read just after, each flush's lanes
             recorded (FlushLog). (a) The reference's serving levels
             (bench.py's _bench_serving_levels): light (100 transactions
             of 2 fresh signatures, 1 submitter, closed loop), concurrent
             (500, 8 submitters) and saturation (1,000, open loop) under
             glv and under w4, and saturation under msm (Schnorr), each
             beside its synchronous control (verify_batch(backend="cpu")
             a transaction on 8 threads; under msm on 8 transactions: the
             Python oracle): tx/s, p50 and p99 ms of both, flushes by
             reason and lanes, launches per kernel and bucket, the card's
             busy share estimated from them, fallbacks; every verdict the
             host oracle's, no flush error, fault fallback, KAT failure or
             breaker fallback, the CPU engine's signatures exactly the
             lanes of the flushes under CPU_FLOOR, at saturation a
             2,048-lane launch under glv and w4, K9 launched under msm.
             (b) A storm of about 1,100 transactions (a sigchain chain's
             fan-out outputs: 2-input P2PKH, parent -> child chains, one
             tampered, 4 Schnorr-signed) through an in-process Node with
             the defaults (-sigservice=on) from 8 threads, then 64, and
             through a control Node (-sigservice=off -tpu=0): the same
             mempool, the tampered one rejected with
             mandatory-script-verify-flag-failed on both, a block mined
             over the serviced mempool connected on the control with the
             same tip; accept p50 and p99 and the service's snapshot.
             (d) The drill: the GLV entry made unavailable
             (ops/cuda_build.entry raising KernelUnavailable for
             glv_dev_verify*): submit(...).result() raises it and the
             service thread dies; restored, a new service's verdicts are
             right.
5b. big blocks — the validation path with the device Merkle leg: a
             regtest chain of one-input transactions
             (workload/sigchain.generate, 13,286 sigs, 4,095 a block:
             three blocks of 4,096 leaves, one of 1,002) through a
             ChainstateManager under the default GLV kernel, counts zeroed
             just before and read just after: merkle_tree once for each
             block of 512 leaves or more, the host compute_merkle_root for
             none of them, no merkle or sha256 fallback, the coin digest
             and best block equal to the CPU engine's; the Merkle leg's
             time beside the host's per block. Then a crafted block with a
             duplicated tail (bad-txns-duplicate) and one with an altered
             header root (bad-txnmrklroot), each with one host
             confirmation.
5c. schnorr — dispatch_batch(backend="device", kernel="msm") at 8, 31,
             127, 2046 and 8190 Schnorr signatures (sigs/s, the MSM
             time split into host work, kernel calls and canaries;
             verdicts equal to the oracle's at 8 and 31, whose sigs/s are
             printed, all True above), one forged lane at 2046 (False at
             that lane only; bisect depth and counters), the drills at
             ecdsa_msm (fail-always, poison-output: the oracle serves,
             verdicts unchanged); then the Schnorr path: an 8,000-signature
             Schnorr chain (workload/sigchain, 250 inputs a transaction, 8
             a block) through a ChainstateManager under -ecdsakernel=msm
             three times at pipeline depth 8 (the 2046-lane LanePacker:
             batches at bucket 4096), each with its coin digest and best
             block equal to the same blocks connected without script
             checks, the tampered tip rejected, MSM launches and the GLV
             launches of its ECDSA lanes counted, no fallback; 64 lanes
             drawn at random held against the oracle. And one
             dispatch_packed slice of 8190 ECDSA signatures under
             -ecdsakernel=msm: the w4 byte entry launched (the reference's
             gate), no GLV launch, the oracle's verdicts.
6. mining  — the mining main path at difficulty 1 (testnet, nBits
             0x1d00ffff: 2^32 hashes a block on average): generate_blocks
             on an on-disk testnet ChainstateManager with the exact engine
             (the supervised default, 4 blocks), then h7, pallas-h7 and
             resident-h7 (2 blocks each); every block connected, every
             hash host-verified, no miner fallback, each engine's entry
             launched (counts zeroed just before each engine, read just
             after). Per engine: blocks, hashes swept, wall s, GH/s end to
             end, and the kernel's share of the wall.
6b. headers — a 2,000-header regtest chain through
             consensus/pow.check_headers_pow_batch: verdicts equal to
             per-header check_proof_of_work, one sha256d_headers launch at
             B = 2048; again with a header at nBits 0x1d00ffff whose nonce
             misses (False, one host confirmation) and phase 6's testnet
             headers; store/certificate.mmr_root over the chain's hashes
             equal to a hashlib MMR, one sha256d_pairs launch for each
             level of 128 pairs or more.
6c. gate   — the host compute_merkle_root beside the device leg end to
             end (ops/dispatch.merkle_root) at 128, 512, 1024 and 4096
             leaves.
7a. shard sigs — the sharded signature path (parallel/sig_shard, K13):
             verify_batch_sharded on 8,190 records (valid, forged,
             GLV-degenerate and w4-degenerate lanes, q_inf lanes of an
             out-of-range r) under glv and w4, at chip_mesh() (every card:
             width 1 here) and on [cuda:0] * 4 (four shards on the card,
             each on a stream of its own), counts zeroed just before each
             call and read just after: one launch of the per-shard entry
             a shard at the shard's bucket (8192, or 2048 a shard), no
             other launch, no fallback; verdicts equal to the oracle's and
             to the unsharded dispatch_batch's. The GLV host-split route
             through _sharded_glv at both layouts. The kept staging
             reused at each layout and kernel: another batch, a smaller
             one at the same lanes a shard, one at fewer, the first
             again, each call's verdicts its own oracle's, and the
             smaller batch's planes (its padding lanes report nothing).
             Then, for each sharded program (glv_dev_verify, glv_verify,
             w4_verify_bytes a shard) on the same packed arrays: the
             call's wall at each layout beside the unsharded wrapper's,
             the breakdown of the main path's call (parallel/mesh.PARTS:
             pack, stage, submit, wait, copy-back, fold, re-check; the
             shards' kernel spans from CUDA events), the plain version's
             wall and the bound. A batch of four cards' waves (the
             records tiled four times, 32,760) at each layout of width 4:
             verdicts, one launch a shard, no fallback, and each
             program's wall and breakdown beside the unsharded wrapper's
             at 32,768 lanes on one card.
7b. shard msm — msm_is_infinity_sharded on the terms of msm_inputs at
             4,096 and 16,384 (the buckets of 2,046 and 8,190 Schnorr
             signatures), sums nonzero and zero, at both layouts: one
             msm_partial launch a shard, the verdict equal to
             schnorr_msm_is_infinity's and the host's sum; 100 terms on
             four shards, two of them padding alone (at infinity, skipped
             by the fold), each partial the host's sum of its shard; the
             kept staging reused (a smaller batch of known logs after the
             larger ones, its sum nonzero and zero, then its shards'
             partials); the walls beside the unsharded
             msm_partial_point's, the breakdown, plain, bound; the last
             size's terms tiled four times (57,344 terms, 16,384 a shard)
             at each layout of width 4: the verdict the host's, one
             launch a shard, the wall and the breakdown.
7c. shard nonces — sweep_header_sharded on a testnet difficulty-1
             header whose first hit lies in [2^24, 2^27), at both layouts:
             from nonce 0 the nonce equals the exact engine's first hit;
             from 2^32 - 2^28 over 2^30 nonces (stripes past 2^32 wrap)
             each shard's tiles and hit equal one unsharded launch over
             its stripe; one sweep_exact launch a shard; a testnet block
             mined through generate_blocks(..., sweep=sweep_header_sharded)
             at each layout; walls, plain, bound.
8. daemon  — python -m bitcoincashplus_tpu_torch.cli.bcpd -regtest
             -reindex -residentminer=off on a copy of phase 5d's chain, on
             the card under the default GLV, driven over JSON-RPC:
             getblockchaininfo and gettxoutsetinfo (height, tip and muhash
             equal to phase 5d's -tpu=0 run), gettpuinfo (the card's name,
             glv, device programs dispatched, every fallback counter 0),
             startprofile, submitblock of the tampered tip (the tip stays;
             sent again, "duplicate-invalid") and of the good tip (the
             tip moves), stopprofile (the Chrome trace names a port
             kernel), one bcp_cli getblockcount, generatetoaddress 1 (the
             h7-dispatch engine); then live traffic (phase 5e(c)): three
             mature coinbases fanned out by sendrawtransaction and mined,
             64 2-input transactions spending them sent to
             sendrawtransaction from 8 client threads, each answered with
             its txid and in the mempool, gettpuinfo's serving section
             read (no flush error, fault or breaker fallback); stop
             (exit 0).
9. report  — a JSON line of the kernel entries (the fifteen kernels and
             the five sharded programs) with launches on their paths,
             errors, times and bounds; the card's name and power limit;
             last, {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when torch.cuda.is_available() is
false or the port package is not importable.
"""

from __future__ import annotations

import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CHAIN_SIGS = 16_000          # bench.py's reindex size
PACKED_LANES = 8190          # the native engine's dispatch slice
PIPELINE_DEPTH = 8
# the validation runs of phase 5, in order: each kernel as often first
# as last, so host warm-up does not fall on one of them
PATH_ORDER = ("glv", "w4", "w4", "glv", "glv", "w4", "w4", "glv")
# both w4 entries at every shape: 2048 is the LanePacker's bucket, 8192
# dispatch_packed's, 32 and 128 the plane entry's
W4_SHAPES = (32, 128, 1024, 2048, 8192, 16384)
W4_TEAMS = (1, 2, 4)          # the team sizes the .cu compiles
W4_BLOCKS = (32, 64, 128)     # threads a block tried at each team size
# H100: 132 SMs; 64 32-bit integer multiply-adds per SM per clock
# (CUDA C++ Programming Guide, arithmetic instruction throughput, cc 9.0)
SMS = 132
IMAD_PER_SM_CLK = 64
HBM_BYTES_S = 3.35e12
# 32-bit IMADs per field multiply: 64 + 9 products of 32x32->64 bits, two
# IMADs each (low and high half); a squaring needs 36 + 9 — see
# csrc/w4_verify.cu
IMAD_PER_FMUL = 2 * (64 + 9)
IMAD_PER_FSQR = 2 * (36 + 9)
# (squarings, multiplies) of each formula in csrc/w4_verify.cu
SQR_MUL_DOUBLE, SQR_MUL_MADD, SQR_MUL_FADD, SQR_MUL_FINAL = \
    (5, 2), (3, 8), (4, 12), (1, 2)
# Operands of the w4 field core's self-test (and of its CPU model,
# tests/test_torch_w4_design.py) that random signatures never reach: the
# ends of the lazy range [0, 2^256), p and its neighbours, the fold
# constant 2^32 + 977, words of all ones and zeros
_P = 2**256 - 2**32 - 977
FIELD_EDGES = [0, 1, 2, 977, 2**32 + 977, 2**32 - 1, _P - 1, _P, _P + 1,
               2**256 - 2**32 - 978, 2**256 - 1, 2**256 - 2, 2**255,
               (2**32 - 1) << 224, int("ffffffff00000000" * 4, 16),
               int("00000000ffffffff" * 4, 16)]
FIELD_RANDOM_PAIRS = 4096
# dependent steps of each timed field chain (field_chains)
CHAIN_STEPS = 2000
# The GLV entries at the validation path's byte buckets (1024 the GLV
# floor, 2048 the LanePacker's, 8192 dispatch_packed's) and the split size
GLV_SHAPES = (1024, 2048, 8192, 16384)
# the split's edges: 0, 1, 2, n - 1, n - 2, lambda and its neighbours,
# n - lambda, n / 2, 2^128 and 2^128 - 1, 2^255, and scalars of all-ones
# limbs or words (2^256 - 1 above n: the split of k equals that of k mod n)
_N = 2**256 - 0x14551231950B75FC4402DA1732FC9BEBF
_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
GLV_EDGES = [0, 1, 2, _N - 1, _N - 2, _LAMBDA, _LAMBDA - 1, _LAMBDA + 1,
             _N - _LAMBDA, _N // 2, 2**128, 2**128 - 1, 2**255, 2**127,
             int("1fff" * 16, 16) % _N, 2**256 - 1]
GLV_RANDOM_SCALARS = 4096
# H100: 64 32-bit integer operations (IADD3, LOP3, SHF, PRMT, ISETP) per
# SM per clock (CUDA C++ Programming Guide, arithmetic instruction
# throughput, cc 9.0)
INT_OPS_PER_SM_CLK = 64

# The sweep kernels: entry -> [(tile, n_tiles)] of the launches compared
# with the plain version at 8 starts, a straddle and a no-hit launch: each
# main-path tile at 2^25 nonces a launch (the Pallas contract's own
# launch: 64 x 128 lanes x 4096 tiles), and the resident loop's segment
# (tile 2^16 x 8 tiles) as it is. The whole-space launches of the exact
# and h7 engines are compared in whole_space_case.
SWEEP_CONFIGS = {
    "sweep_h7": [(1 << 20, 32), (1 << 16, 8)],
    "sweep_h7_pallas": [(64 * 128, 4096)],
    "sweep_exact": [(1 << 16, 512)],
}
SWEEP_STARTS = 8              # seeded starts at ~1 candidate a launch
GENESIS_NONCE = 2083236893    # the mainnet genesis block's nonce
GENESIS_WINDOW = 1 << 28
DIFF1_BITS = 0x1D00FFFF
MINING_BLOCKS = {"exact": 4, "h7": 2, "pallas-h7": 2, "resident-h7": 2}
MAX_TRIES = 16 << 32          # several full nonce spaces a block


_T0 = time.monotonic()


def log(msg: str) -> None:
    """A progress line, stamped with the seconds since the script
    started."""
    print(f"[chip_smoke +{time.monotonic() - _T0:.1f}s] {msg}", flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return out.strip().splitlines()[0]


# ---- inputs -----------------------------------------------------------------

def _mul_small(m: int, pt):
    """m pt for a small m by double-and-add over m's bits (a few point
    operations; the oracle's point_mul walks 256 bits, about 0.1 s)."""
    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O

    acc = None
    for bit in bin(m)[2:]:
        acc = O.point_add(O.point_double(acc), pt if bit == "1" else None)
    return acc


def signed_records(n: int, seed: int) -> list:
    """n seeded ECDSA SigCheckRecords over 32 keys (d0 .. d0 + 31), every
    4th one invalid (message off by one), plus one crafted degenerate lane
    every 97 lanes: pubkey G and message hash e = r, so u1 == u2 and the
    first nonzero window adds jG to jG (H == 0); their nonces run k0,
    k0 + 1, ... so that each R is one point add from the last. The
    degenerate signature is valid."""
    from bitcoincashplus_tpu_torch import native
    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O
    from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord

    rng = random.Random(seed)
    d0 = rng.randrange(1, O.N - 32)
    keys = [d0 + j for j in range(32)]
    pubs = [O.point_mul(d0, O.G)]
    for _ in keys[1:]:
        pubs.append(O.point_add(pubs[-1], O.G))
    k = rng.randrange(1, O.N - n)
    R = O.point_mul(k, O.G)
    sign = native.ecdsa_sign if native.available() else O.ecdsa_sign
    out = []
    for i in range(n):
        if i % 97 == 5:
            r = R[0] % O.N
            s = pow(k, O.N - 2, O.N) * (2 * r) % O.N  # d = 1, e = r
            out.append(SigCheckRecord(O.G, r, s, r))
            k, R = k + 1, O.point_add(R, O.G)
            continue
        j = rng.randrange(len(keys))
        e = rng.getrandbits(256) % O.N
        r, s = sign(keys[j], e)
        if i % 4 == 1:
            e = (e + 1) % O.N
        out.append(SigCheckRecord(pubs[j], r, s, e))
    return out


def craft_lanes(arrays: dict, n: int, be: bool) -> dict:
    """Mark lane kinds on packed arrays: q_inf lanes (every 37th), and wrap
    lanes where r0 is wrong and rn carries the true r — accepted only when
    wrap is set (every 53rd, set; every 59th, cleared)."""
    import numpy as np

    kinds = {"q_inf": [], "wrap_on": [], "wrap_off": []}
    for i in range(n):
        if i % 37 == 3:
            kinds["q_inf"].append(i)
        elif i % 53 == 7:
            kinds["wrap_on"].append(i)
        elif i % 59 == 11:
            kinds["wrap_off"].append(i)
    qi = arrays["q_inf"]
    qi[kinds["q_inf"]] = 1
    for key, flag in (("wrap_on", 1), ("wrap_off", 0)):
        idx = kinds[key]
        if be:
            arrays["rn"][idx] = arrays["r0"][idx]
            arrays["r0"][idx] ^= np.uint8(0x5A)
        else:
            arrays["rn"][:, idx] = arrays["r0"][:, idx]
            arrays["r0"][:, idx] ^= np.uint32(0x155)
        arrays["wrap"][idx] = flag
    return kinds


def glv_records(n: int, seed: int) -> list:
    """signed_records with a GLV-degenerate lane every 89 lanes (from lane
    20): pubkey G and verify scalars u1 = a + d 256^j, u2 = d 256^j - a
    (a < 256^j, both below 2^127, so k1 = u and k2 = 0): the ladder leaves
    (d 256^j - a) G, the comb's teeth 0 .. j-1 add a G, and tooth j adds
    d 256^j G to itself (H == 0). The signature is valid. (signed_records'
    own degenerate lanes collide only in the w4 schedule.)"""
    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O
    from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord

    out = signed_records(n, seed)
    rng = random.Random(seed + 1)
    # 256^j G, j = 0 .. 14: (u1 + u2) G = 2 t 256^j G in a few point adds
    base = [O.G]
    for _ in range(14):
        base.append(_mul_small(256, base[-1]))
    for i in range(20, n, 89):
        j = rng.randrange(15)
        a = rng.randrange(256 ** j)
        t = rng.randrange(1, 256)
        top = t * 256 ** j
        u1, u2 = a + top, top - a
        r = _mul_small(2 * t, base[j])[0] % O.N
        s_ = r * pow(u2, O.N - 2, O.N) % O.N
        out[i] = SigCheckRecord(O.G, r, s_, u1 * s_ % O.N)
    return out


def imad_count(u1w, u2w, q_inf) -> int:
    """The least 32-bit IMADs the verify needs on this data: per finite
    lane the Q table, then from the first nonzero window on 4 doublings
    and a G / Q add per nonzero window (the first add into infinity is a
    copy), and the final check; each squaring at its own cost. (B, 64)
    window arrays."""
    import numpy as np

    dbl, madd, fadd, final = (s * IMAD_PER_FSQR + m * IMAD_PER_FMUL
                              for s, m in (SQR_MUL_DOUBLE, SQR_MUL_MADD,
                                           SQR_MUL_FADD, SQR_MUL_FINAL))
    u1w = np.asarray(u1w).astype(np.int64)
    u2w = np.asarray(u2w).astype(np.int64)
    live = ~np.asarray(q_inf, bool)
    any_nz = (u1w != 0) | (u2w != 0)
    first = np.where(any_nz.any(1), any_nz.argmax(1), 64)
    k = np.arange(64)[None, :]
    after = k > first[:, None]
    at = k == first[:, None]
    imads = (dbl + 13 * madd + final
             + 4 * dbl * after.sum(1)
             + madd * ((u1w != 0) & after).sum(1)
             + fadd * ((u2w != 0) & after).sum(1)
             # first window: a Q add follows a G copy into infinity
             + fadd * ((u1w != 0) & (u2w != 0) & at).sum(1))
    return int(imads[live].sum())


def glv_imad_count(ladder, comb, q_inf, split: bool) -> int:
    """The least 32-bit IMADs a GLV verify needs on this data, per finite
    lane: the T1 build, 15 beta X products (the lambda Q table), from the
    first nonzero window on 4 doublings a window, a cheap full add per
    nonzero window (the first add into infinity is a copy), a cheap mixed
    add per nonzero comb digit (a copy if the ladder left infinity), the
    final check, and with ``split`` the lattice split of u1 and u2 (324
    products of 32 x 32 -> 64 bits a scalar, two IMADs each). ladder:
    (B, 64) windows, the Q and lambda Q stream of each window in turn;
    comb: (B, 32) digits, the G and lambda G digit of each tooth in
    turn."""
    import numpy as np

    dbl, madd, fadd, final = (s * IMAD_PER_FSQR + m * IMAD_PER_FMUL
                              for s, m in (SQR_MUL_DOUBLE, SQR_MUL_MADD,
                                           SQR_MUL_FADD, SQR_MUL_FINAL))
    ladder = np.asarray(ladder) != 0
    comb = np.asarray(comb) != 0
    live = ~np.asarray(q_inf, bool)
    window = ladder.reshape(-1, 32, 2).any(2)
    first = np.where(window.any(1), window.argmax(1), 32)
    doublings = np.maximum(0, 31 - first)
    started = window.any(1)
    fadds = ladder.sum(1) - started
    madds = comb.sum(1) - (~started & comb.any(1))
    imads = (dbl + 13 * madd + 15 * IMAD_PER_FMUL + final
             + 4 * dbl * doublings + fadd * fadds + madd * madds
             + (2 * 2 * 324 if split else 0))
    return int(imads[live].sum())


def hold(ok_k, dg_k, plain_out, oracle, kinds: dict, n: int,
         where: str) -> tuple:
    """Hold one kernel result (ok, degen) against the plain version's and
    the oracle's: degen equal everywhere, ok equal on non-degen lanes, the
    verdicts after the host re-check of degen lanes equal to the oracle on
    the uncrafted record lanes, q_inf and padding lanes silent, the wrap
    gate right, at least one degen lane. Returns (max_abs_err, degen
    lanes)."""
    import numpy as np

    ok_p, dg_p = (t.cpu().numpy() for t in plain_out)
    ok_k, dg_k = ok_k.cpu().numpy(), dg_k.cpu().numpy()
    crafted = set(kinds["q_inf"]) | set(kinds["wrap_on"]) | \
        set(kinds["wrap_off"])
    plain_lanes = np.array([i not in crafted for i in range(n)])
    err = max(int(np.abs(ok_k.astype(int) - ok_p.astype(int))[~dg_k].max(
        initial=0)), int(np.abs(dg_k.astype(int) - dg_p.astype(int)).max()))
    if not np.array_equal(dg_k, dg_p):
        raise AssertionError(f"{where}: degen planes differ at "
                             f"{np.nonzero(dg_k != dg_p)[0][:10]}")
    nd = ~dg_k
    if not np.array_equal(ok_k[nd], ok_p[nd]):
        raise AssertionError(f"{where}: ok differs on non-degen lanes "
                             f"{np.nonzero((ok_k != ok_p) & nd)[0][:10]}")
    # verdicts after the host re-check of degen lanes, on the record lanes
    final = np.where(dg_k[:n], oracle, ok_k[:n])
    if not np.array_equal(final[plain_lanes], oracle[plain_lanes]):
        raise AssertionError(f"{where}: verdicts differ from the oracle")
    if ok_k[kinds["q_inf"]].any() or dg_k[kinds["q_inf"]].any():
        raise AssertionError(f"{where}: a q_inf lane reported")
    if ok_k[n:].any() or dg_k[n:].any():
        raise AssertionError(f"{where}: a padding lane reported")
    # degen lanes carry garbage by contract: the gate is read on the rest
    won = [i for i in kinds["wrap_on"] if not dg_k[i]]
    woff = [i for i in kinds["wrap_off"] if not dg_k[i]]
    if not np.array_equal(ok_k[won], oracle[won]) or ok_k[woff].any():
        raise AssertionError(f"{where}: wrap gate wrong")
    n_degen = int(dg_k.sum())
    if n_degen < 1:
        raise AssertionError(f"{where}: no degenerate lane flagged")
    return err, n_degen


# ---- phases -----------------------------------------------------------------

def time_cuda(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up, by CUDA
    events around the whole run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_once(fn, dev) -> tuple:
    """(ms, result) of one call, synchronised on a CUDA device."""
    import torch

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return (time.perf_counter() - t0) * 1e3, out


def time_device(fn, clock_hz: float, reps: int = 50) -> float:
    """Mean device ms of one call of ``fn`` for a kernel shorter than the
    host's per-call overhead: the calls are enqueued behind a spin kernel
    (torch.cuda._sleep) that outlasts their enqueue, so the events around
    them time the card's back-to-back work, not the host's calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per_call = time.perf_counter() - t0
    spin_s = 4 * per_call * reps + 1e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * clock_hz))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    if enqueue_s > spin_s / 2:
        raise AssertionError(f"time_device: the enqueue ({enqueue_s:.6f} s) "
                             f"was not hidden behind the spin ({spin_s} s)")
    return start.elapsed_time(end) / reps


def entry_call(name: str, argtypes: list, *args):
    """A zero-argument call of the C entry ``name`` with ``args`` on the
    current stream (no wrapper: no allocation, no launch count), its
    return code checked."""
    import torch

    from bitcoincashplus_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    return lambda: cuda_build.launch(name, argtypes, dev, *args)


def host_oracle(recs):
    """Host verdicts: the native C++ batch verify (the Python-int oracle
    where the library did not build)."""
    import numpy as np

    from bitcoincashplus_tpu_torch import native
    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O

    if native.available():
        return np.asarray(native.ecdsa_verify_batch(recs), bool)
    return np.array([O.ecdsa_verify(r.pubkey, r.r, r.s, r.msg_hash)
                     for r in recs])


def kernel_case(entry: str, B: int, seed: int, clock_hz: float,
                device: str = "cuda") -> dict:
    """One entry at one shape: the kernel at every team size and block
    size against the plain version on the card, verdicts after the host
    re-check against the oracle, times and bound. (On a CPU device the
    wrapper itself takes the plain version: a rehearsal of the checks.)"""
    import numpy as np
    import torch

    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    n = B - 3  # three padding lanes (q_inf by the packer)
    recs = signed_records(n, seed)
    be = entry == "w4_verify_bytes"
    if be:
        a = E.pack_records_w4_bytes(recs, B)
        arrays = dict(zip(("u1", "u2", "qx", "qy", "q_inf", "r0", "rn",
                           "wrap"), [x.copy() for x in a]))
    else:
        a = E.pack_records_w4(recs, B)
        arrays = dict(zip(("u1", "u2", "qx", "qy", "q_inf", "r0", "rn",
                           "wrap"), [x.copy() for x in a]))
        arrays["q_inf"] = arrays["q_inf"].astype(np.uint8)
        arrays["wrap"] = arrays["wrap"].astype(np.uint8)
    kinds = craft_lanes(arrays, n, be)
    order = ("u1", "u2", "qx", "qy", "q_inf", "r0", "rn", "wrap")
    dev = torch.device(device)
    tens = []
    for k in order:
        x = np.ascontiguousarray(arrays[k])
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        tens.append(torch.from_numpy(x).to(dev))
    wrapper = (S.ecdsa_verify_batch_pallas_w4_bytes if be
               else S.ecdsa_verify_batch_pallas_w4)
    plain = S.w4_verify_bytes_plain if be else S.w4_verify_planes_plain
    # the byte wrapper takes multiples of 1024 lanes (the reference's
    # contract); its entry is launched directly at the smaller shapes
    wrapped = not be or B % 1024 == 0

    plain_ms, plain_out = time_once(lambda: plain(*tens), dev)
    oracle = host_oracle(recs)

    def check(ok_k, dg_k, what: str) -> tuple:
        return hold(ok_k, dg_k, plain_out, oracle, kinds, n,
                    f"{entry} B={B} {what}")

    times, errs = {}, []
    if dev.type == "cuda":
        for team in W4_TEAMS:
            for block in W4_BLOCKS:
                def launch(team=team, block=block):
                    ok, dg = S._launch(entry, tens, B, team, block)
                    return ok.view(torch.bool), dg.view(torch.bool)

                err, n_degen = check(*launch(), f"T={team} block={block}")
                errs.append(err)
                times[team, block] = time_cuda(launch,
                                               20 if B <= 8192 else 10)
        shape = S.launch_shape(B)
        if wrapped:
            errs.append(check(*wrapper(*tens), "wrapper")[0])
        ms = times[shape]
    else:
        shape = None
        run = (lambda: wrapper(*tens)) if wrapped else (lambda: plain(*tens))
        ms, out = time_once(run, dev)
        err, n_degen = check(*out, "wrapper")
        errs.append(err)
    if be:
        b = verify_bound(entry, arrays, B, clock_hz)
    else:
        imads = imad_count(arrays["u1"].T, arrays["u2"].T,
                           arrays["q_inf"] != 0)
        b = {**bound(imads, B * (2 * 64 * 4 + 4 * 20 * 4 + 2) + 2 * B,
                     clock_hz), "imads": imads}
    return {"B": B, "ms": ms, "plain_ms": plain_ms, **b,
            "max_abs_err": max(errs), "degen_lanes": n_degen,
            "sigs_per_s": B / (ms / 1e3), "shape": shape,
            "times": {f"{t}x{b}": v for (t, b), v in times.items()}}


def glv_case(entry: str, B: int, seed: int, clock_hz: float,
             device: str = "cuda") -> dict:
    """One GLV entry (glv_dev_verify from the w4 byte matrices, glv_verify
    from the host split of ops/ecdsa_batch.pack_records_glv) at one shape:
    the kernel at every team size and block size against the plain
    version on the card (hold), times, and the IMAD bound. (On a CPU
    device the wrapper itself takes the plain version: a rehearsal.)"""
    import numpy as np
    import torch

    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    n = B - 3  # three padding lanes (q_inf by the packer)
    recs = glv_records(n, seed)
    dev_split = entry == "glv_dev_verify"
    if dev_split:
        names = ("u1", "u2", "qx", "qy", "q_inf", "r0", "rn", "wrap")
        packed = E.pack_records_w4_bytes(recs, B)
    else:
        names = ("d1", "d2", "sg1", "sg2", "s1", "s2", "ydiff", "qx", "qy",
                 "q_inf", "r0", "rn", "wrap")
        packed = E.pack_records_glv(recs, B)
    arrays = dict(zip(names, [np.ascontiguousarray(x).copy()
                              for x in packed]))
    kinds = craft_lanes(arrays, n, True)
    dev = torch.device(device)
    tens = [torch.from_numpy(arrays[k]).to(dev) for k in names]
    wrapper = (S.ecdsa_verify_batch_glv_dev if dev_split
               else S.ecdsa_verify_batch_glv)
    plain = S.glv_dev_verify_plain if dev_split else S.glv_verify_plain
    plain_ms, plain_out = time_once(lambda: plain(*tens), dev)
    oracle = host_oracle(recs)

    def check(ok_k, dg_k, what: str) -> tuple:
        return hold(ok_k, dg_k, plain_out, oracle, kinds, n,
                    f"{entry} B={B} {what}")

    times, errs = {}, []
    chain = S.launch_shape(B)  # the carry-chain design at w4's table
    if dev.type == "cuda":
        for team in S.GLV_TEAMS:
            for block in W4_BLOCKS:
                def launch(team=team, block=block):
                    out = S._launch(entry, tens, B, team, block)
                    return out[0].view(torch.bool), out[1].view(torch.bool)

                err, n_degen = check(*launch(),
                                     f"{team_name(team)} block={block}")
                errs.append(err)
                times[team, block] = time_cuda(launch,
                                               20 if B <= 8192 else 10)
        shape = S.launch_shape(B, S.GLV_LAUNCH)
        err, n_degen = check(*wrapper(*tens), "wrapper")
        errs.append(err)
        ms = times[shape]
    else:
        shape = None
        ms, out = time_once(lambda: wrapper(*tens), dev)
        err, n_degen = check(*out, "wrapper")
        errs.append(err)
    return {"B": B, "ms": ms, "plain_ms": plain_ms,
            **verify_bound(entry, arrays, B, clock_hz),
            "max_abs_err": max(errs), "degen_lanes": n_degen,
            "sigs_per_s": B / (ms / 1e3), "shape": shape,
            "chain_shape": chain, "chain_ms": times.get(chain),
            "warps_per_scheduler": warps_per_scheduler(B, shape),
            "times": {f"{t}x{b}": v for (t, b), v in times.items()}}


def verify_bound(entry: str, arrays: dict, B: int, clock_hz: float) -> dict:
    """The bound of a byte-matrix verify entry (w4_verify_bytes,
    glv_dev_verify, glv_verify) on these inputs (numpy arrays named as in
    glv_case): the IMADs this data needs (imad_count, glv_imad_count) over
    the card's IMAD rate, against the bytes in and out over HBM (the GLV
    comb read once)."""
    import numpy as np
    import torch

    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    if entry == "w4_verify_bytes":
        u1w, u2w = (S._expand_nibble_windows(torch.from_numpy(
            np.ascontiguousarray(arrays[k]))).T.numpy() for k in ("u1", "u2"))
        imads = imad_count(u1w, u2w, arrays["q_inf"] != 0)
        return {**bound(imads, B * (6 * 32 + 2) + 2 * B, clock_hz),
                "imads": imads}
    dev_split = entry == "glv_dev_verify"
    if dev_split:
        m1, _n1, m2, _n2 = (t.numpy() for t in S.glv_decompose_plain(
            torch.from_numpy(np.concatenate([arrays["u1"], arrays["u2"]]))))
        ladder_b = [np.unpackbits(m[B:], axis=1, bitorder="little")
                    for m in (m1, m2)]
        comb_bytes = np.stack([m1[:B], m2[:B]], 2).reshape(B, 32)
        in_bytes = B * (6 * 32 + 2)
    else:
        ladder_b = [np.unpackbits(arrays[k][:, ::-1], axis=1,
                                  bitorder="little") for k in ("s1", "s2")]
        comb_bytes = np.stack([arrays["d1"], arrays["d2"]], 2).reshape(B, 32)
        in_bytes = B * (4 * 16 + 3 + 4 * 32 + 2)
    # MSB-first windows of each stream, interleaved Q / lambda Q
    wins = [(b.reshape(B, 32, 4) * (1 << np.arange(4))).sum(2)[:, ::-1]
            for b in ladder_b]
    ladder = np.stack(wins, 2).reshape(B, 64)
    imads = glv_imad_count(ladder, comb_bytes, arrays["q_inf"] != 0,
                           dev_split)
    comb_bytes_total = 3 * 16 * 512 * 32  # the comb, read once
    return {**bound(imads, in_bytes + comb_bytes_total + 2 * B, clock_hz),
            "imads": imads}


def team_name(team: int) -> str:
    """A GLV team code as the log writes it: T=n for the carry-chain
    design, pairs L=n for the pair design (2n threads a lane)."""
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    if team > S.GLV_PAIR:
        return f"pairs L={team - S.GLV_PAIR}"
    return f"T={team}"


def warps_per_scheduler(B: int, shape) -> float | None:
    """Resident warps a warp scheduler (4 an SM) of a GLV launch of B
    lanes at (team code, block): lanes x threads a lane over 32."""
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    if shape is None:
        return None
    return B * S.team_threads(shape[0]) / 32 / (4 * SMS)


def glv_decompose_phase(clock_hz: float, seed: int = 11,
                        device: str = "cuda") -> dict:
    """The decompose-only surface (glv_decompose_device_batch, entry
    glv_decompose) driven through its wrapper on GLV_EDGES and
    GLV_RANDOM_SCALARS seeded scalars below n, counts zeroed just before
    and read just after; every lane equal to the Python glv_decompose,
    and the whole output equal to the plain version's on the card (error
    0). Then the kernel timed and its bound."""
    import numpy as np
    import torch

    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    rng = random.Random(seed)
    ks = GLV_EDGES + [rng.randrange(O.N) for _ in range(GLV_RANDOM_SCALARS)]
    km = torch.from_numpy(np.frombuffer(
        b"".join(k.to_bytes(32, "big") for k in ks), np.uint8).reshape(
            len(ks), 32).copy()).to(device)
    S.reset_launch_counts()
    out = S.glv_decompose_device_batch(km)
    launches = S.LAUNCHES["glv_decompose"]
    got = [t.cpu().numpy() for t in out]
    bad = []
    for i, k in enumerate(ks):
        lane = (int.from_bytes(got[0][i].tobytes(), "little"),
                int(got[1][i]), int.from_bytes(got[2][i].tobytes(), "little"),
                int(got[3][i]))
        if lane != S.glv_decompose(k):
            bad.append(hex(k))
    if bad:
        raise AssertionError(f"glv_decompose: {len(bad)} lanes differ from "
                             f"the Python split, first {bad[:5]}")
    dev = torch.device(device)
    plain_ms, ref = time_once(lambda: S.glv_decompose_plain(km), dev)
    err = max(int(np.abs(a.astype(int) - b.cpu().numpy().astype(int)).max())
              for a, b in zip(got, ref))
    if err:
        raise AssertionError(f"glv_decompose: differs from the plain "
                             f"version by {err}")
    B = len(ks)
    parts = {}
    if dev.type == "cuda":
        ms = time_cuda(lambda: S.glv_decompose_device_batch(km), 20)
        parts = decompose_parts(km, clock_hz)
    else:
        ms = time_once(lambda: S.glv_decompose_device_batch(km), dev)[0]
    ops_ms = B * 2 * 324 / (SMS * IMAD_PER_SM_CLK * clock_hz) * 1e3
    bytes_ms = B * (32 + 2 * 16 + 2) / HBM_BYTES_S * 1e3
    return {"B": B, "edges": len(GLV_EDGES), "ms": ms, "plain_ms": plain_ms,
            "parts": parts, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "max_abs_err": err, "launches": launches}


def host_us(fn, reps: int = 200) -> float:
    """Median host microseconds of one call of ``fn`` (no synchronise:
    the host's own cost)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def decompose_parts(km, clock_hz: float) -> dict:
    """The glv_decompose wrapper's parts on ``km``, host clock: the typed
    entry's lookup as the wrapper makes it (kept) and as every call made
    it before (a walk of the libraries, a new typing); the four output
    allocations the wrapper made before beside its one now; the C entry's
    launch alone; the whole wrapper; and the kernel's device time behind
    a spin (time_device, as K1 is timed)."""
    import ctypes

    import torch

    from bitcoincashplus_tpu_torch.ops import cuda_build
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    B, dev = km.shape[0], km.device
    argtypes = S._DECOMPOSE_ARGS

    def walk():
        for lib in cuda_build.kernel_libs():
            if hasattr(lib, "glv_decompose"):
                fn = getattr(lib, "glv_decompose")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                return fn

    def four():
        m1 = torch.empty(B, 16, dtype=torch.uint8, device=dev)
        torch.empty_like(m1)
        n1 = torch.empty(B, dtype=torch.uint8, device=dev)
        torch.empty_like(n1)

    out = torch.empty(34 * B, dtype=torch.uint8, device=dev)
    fn = cuda_build.entry("glv_decompose", argtypes)
    o, k = out.data_ptr(), km.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = lambda: fn(k, o, o + 32 * B, o + 16 * B, o + 33 * B, B, stream)
    parts = {
        "entry_kept_us": host_us(lambda: cuda_build.entry("glv_decompose",
                                                          argtypes)),
        "entry_walk_us": host_us(walk),
        "alloc_four_us": host_us(four),
        "alloc_one_us": host_us(lambda: torch.empty(34 * B,
                                                    dtype=torch.uint8,
                                                    device=dev)),
        "launch_us": host_us(launch),
        "wrapper_us": host_us(lambda: S.glv_decompose_device_batch(km)),
    }
    torch.cuda.synchronize()
    parts["kernel_ms"] = time_device(launch, clock_hz)
    parts["wrapper_device_ms"] = time_device(
        lambda: S.glv_decompose_device_batch(km), clock_hz)
    return parts


def field_selftest(seed: int = 7) -> dict:
    """The w4 kernel's field core alone (entry w4_field_selftest) on every
    pair of FIELD_EDGES and FIELD_RANDOM_PAIRS seeded random pairs in the
    lazy range [0, 2^256), against Python ints: each result congruent mod p
    (and below 2^256, as 8 words are), fe_canon exact, the zero test and
    fe_eq exact. Raises on any error; returns the counts."""
    import ctypes

    import numpy as np
    import torch

    from bitcoincashplus_tpu_torch.ops import cuda_build

    P = _P
    rng = random.Random(seed)
    pairs = [(a, b) for a in FIELD_EDGES for b in FIELD_EDGES]
    pairs += [(rng.getrandbits(256), rng.getrandbits(256))
              for _ in range(FIELD_RANDOM_PAIRS)]
    # a few lanes of p's multiples and of equal residues, for the zero
    # test and fe_eq
    pairs += [(P, 0), (0, P), (P + 5, 5), (5, P + 5)]

    def to_words(vals):
        w = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                      for v in vals], np.uint32)
        return torch.from_numpy(w.view(np.int32)).cuda()

    a = to_words([x for x, _ in pairs])
    b = to_words([y for _, y in pairs])
    out = torch.empty(len(pairs), 42, dtype=torch.int32, device="cuda")
    fn = cuda_build.entry("w4_field_selftest", [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p])
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), len(pairs),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch("w4_field_selftest", rc)
    res = out.cpu().numpy().view(np.uint32).astype(object)
    bad = []
    for i, (x, y) in enumerate(pairs):
        row = res[i]
        vals = [sum(int(row[8 * k + j]) << (32 * j) for j in range(8))
                for k in range(5)]
        want = [x * y, x * x, x + y, x - y]
        for name, got, exp in zip(("mul", "sqr", "add", "sub"), vals, want):
            if (got - exp) % P:
                bad.append((name, hex(x), hex(y)))
        if vals[4] != x % P:
            bad.append(("canon", hex(x)))
        if int(row[40]) != int(x % P == 0):
            bad.append(("is_zero", hex(x)))
        if int(row[41]) != int((x - y) % P == 0):
            bad.append(("eq", hex(x), hex(y)))
    if bad:
        raise AssertionError(f"w4_field_selftest: {len(bad)} errors, "
                             f"first {bad[:5]}")
    return {"pairs": len(pairs), "edge_pairs": len(FIELD_EDGES) ** 2,
            "random_pairs": FIELD_RANDOM_PAIRS, "errors": 0}


def field_chains(clock_hz: float, seed: int = 9) -> dict:
    """The products the GLV designs are built from (entry glv_field_chain):
    fe_mul, fe_sqr, fe_mul_pair (a multiply split over two threads) and
    fe_add, first one step each on FIELD_EDGES x FIELD_EDGES and
    FIELD_RANDOM_PAIRS // 8 seeded pairs against Python ints (the pair's
    two threads both equal to fe_mul's words), then chains of
    CHAIN_STEPS dependent steps at 1 and 4 warps a scheduler (132 blocks
    of 128 and 512 threads): cycles a step a warp at the card's maximum
    SM clock."""
    import ctypes

    import numpy as np
    import torch

    from bitcoincashplus_tpu_torch.ops import cuda_build

    rng = random.Random(seed)
    pairs = [(x, y) for x in FIELD_EDGES for y in FIELD_EDGES]
    pairs += [(rng.getrandbits(256), rng.getrandbits(256))
              for _ in range(FIELD_RANDOM_PAIRS // 8)]

    def to_words(vals):
        return [(v >> (32 * i)) & 0xFFFFFFFF for v in vals for i in range(8)]

    words = np.array([to_words(p) for p in pairs], np.uint64).astype(
        np.uint32).view(np.int32)
    inp = torch.tensor(words, device="cuda")
    fn = cuda_build.entry("glv_field_chain", [ctypes.c_int] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream

    def run(op, blocks, threads, iters):
        out = torch.empty(blocks * threads * 8, dtype=torch.int32,
                          device="cuda")
        rc = fn(op, inp.data_ptr(), out.data_ptr(), len(pairs), blocks,
                threads, iters, stream)
        cuda_build.check_launch("glv_field_chain", rc)
        return out

    n = 2 * len(pairs)
    blocks = (n + 127) // 128
    res = {op: run(op, blocks, 128, 1).cpu().numpy().view(
        np.uint32).reshape(-1, 8)[:n].astype(object) for op in range(4)}
    bad = []
    for i, (x, y) in enumerate(pairs):
        want = (x * y, x * x, x * y, x + y)
        for op in range(4):
            for t in (2 * i, 2 * i + 1):
                got = sum(int(w) << (32 * k) for k, w in enumerate(res[op][t]))
                if got >= 1 << 256 or (got - want[op]) % _P:
                    bad.append((op, hex(x), hex(y)))
        if list(res[2][2 * i]) != list(res[0][2 * i]):
            bad.append(("pair words", hex(x), hex(y)))
    if bad:
        raise AssertionError(f"glv_field_chain: {len(bad)} errors, first "
                             f"{bad[:5]}")
    cycles = {}
    for op, name in enumerate(("fe_mul", "fe_sqr", "fe_mul_pair", "fe_add")):
        for per_scheduler, threads in ((1, 128), (4, 512)):
            ms = time_cuda(lambda: run(op, SMS, threads, CHAIN_STEPS), 3)
            cycles[f"{name} {per_scheduler} warp(s)/scheduler"] = \
                ms * 1e-3 * clock_hz / CHAIN_STEPS
    return {"pairs": len(pairs), "errors": 0, "cycles_a_step": cycles}


def _zero_counts() -> None:
    from bitcoincashplus_tpu_torch.ops import dispatch
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    dispatch.reset()
    E.STATS.__init__()
    S.reset_launch_counts()


def _read_counts() -> dict:
    from bitcoincashplus_tpu_torch.ops import dispatch
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    return {"launches": dict(S.LAUNCHES),
            "launch_shapes": sorted([name, B, n] for (name, B), n
                                    in S.LAUNCH_SHAPES.items()),
            "stats": E.STATS.snapshot(),
            "healthy": dispatch.breaker("ecdsa").healthy()}


STAT_KEYS = ("dispatches", "sigs_verified", "cpu_fallback_sigs",
             "fault_fallback_sigs", "kat_failures", "degenerate_rechecks",
             "reject_confirm_sigs", "device_seconds", "buckets_used",
             "glv_dispatches", "glv_dev_dispatches", "glv_fallbacks",
             "glv_dev_fallbacks", "glv_emit_s", "glv_dispatch_s")
GLV_ENTRIES = ("glv_dev_verify", "glv_verify", "glv_decompose")
W4_ENTRIES = ("w4_verify_bytes", "w4_verify_planes")


def path_run(workdir: str, gen: dict, blobs: tuple, cpu: dict,
             cpu_packed, kernel: str | None) -> dict:
    """One run of the validation main path, counts zeroed just before and
    read just after: validate_chain(kernel) at PIPELINE_DEPTH, the
    tampered and the good tip, dispatch_packed on the packed blobs (under
    the same kernel as the process default). kernel None is the default,
    GLV; "w4" the rung below it. Checks against the CPU engine's run."""
    import numpy as np

    from bitcoincashplus_tpu_torch.consensus.block import CBlock
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.validation.chain import BlockStatus
    from bitcoincashplus_tpu_torch.workload import sigchain

    if kernel is None and E.active_kernel() != "glv":
        raise AssertionError(f"the default kernel is {E.active_kernel()}")
    if kernel:
        E.set_kernel(kernel)
    try:
        _zero_counts()
        t0 = time.monotonic()
        cs, dev = sigchain.validate_chain(workdir, "device", kernel=kernel,
                                          depth=PIPELINE_DEPTH)
        wall = time.monotonic() - t0
        bad = CBlock.from_bytes(gen["tampered_tip"])
        good = CBlock.from_bytes(gen["good_tip"])
        confirm0 = E.STATS.reject_confirm_sigs
        cs.process_new_block(bad)
        bad_idx = cs.block_index[bad.get_hash()]
        bad_rejected = (bool(bad_idx.status & BlockStatus.FAILED_VALID)
                        and cs.tip().hash == dev_tip(dev))
        bad_device_false = E.STATS.reject_confirm_sigs - confirm0
        cs.process_new_block(good)
        good_accepted = cs.tip().hash == good.get_hash()
        packed = E.dispatch_packed(*blobs, backend="device").result()
        counts = _read_counts()
    finally:
        if kernel:
            E.set_kernel("glv")
    launches, stats = counts["launches"], counts["stats"]
    glv = kernel is None
    ran, idle = (GLV_ENTRIES[:1], W4_ENTRIES + GLV_ENTRIES[1:]) if glv \
        else (W4_ENTRIES, GLV_ENTRIES)
    checks = {
        "digest_equal": dev["digest"] == cpu["digest"],
        "best_equal": dev["best"] == cpu["best"],
        "tampered_rejected": bad_rejected and bad_device_false >= 1,
        "good_tip_accepted": good_accepted,
        "packed_equal_native": bool(np.array_equal(packed, cpu_packed)),
        **{f"launched_{name}": launches[name] > 0 for name in ran},
        **{f"idle_{name}": launches[name] == 0 for name in idle},
        "no_cpu_fallback": stats["cpu_fallback_sigs"] == 0,
        "no_fault_fallback": stats["fault_fallback_sigs"] == 0,
        "no_kat_failures": stats["kat_failures"] == 0,
        "no_glv_fallback": stats["glv_fallbacks"] == 0
        and stats["glv_dev_fallbacks"] == 0,
        "breaker_healthy": counts["healthy"],
    }
    return {"kernel": kernel or "glv", "device": dev, "wall_s": wall,
            "sigs": gen["sigs"], "sigs_per_s": gen["sigs"] / wall,
            "launches": launches, "launch_shapes": counts["launch_shapes"],
            "stats": {k: stats[k] for k in STAT_KEYS},
            "packed_false": int((~packed).sum()), "checks": checks}


def drill_phase(n: int = 200, seed: int = 500) -> dict:
    """The GLV ladder's injected drills (BCP_FAULT_MODE=fail-always) on n
    seeded signatures through verify_batch(backend="device"): at
    ecdsa_glv_dev the device-split leg steps down to glv_verify, at
    ecdsa_glv (consulted by both GLV legs) to the w4 byte entry. Counts
    zeroed just before each drill and read just after; both drills'
    verdicts equal each other and the oracle, nothing served by the
    CPU."""
    import numpy as np

    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.util import faults

    recs = signed_records(n, seed)
    want = host_oracle(recs)
    expect = {E.GLV_DEV_SITE: "glv_verify", E.GLV_SITE: "w4_verify_bytes"}
    rows, verdicts = {}, []
    for site, entry in expect.items():
        os.environ.update(BCP_FAULT_MODE="fail-always", BCP_FAULT_OPS=site)
        faults.INJECTOR.reload()
        try:
            _zero_counts()
            got = E.verify_batch(recs, backend="device")
            counts = _read_counts()
        finally:
            for k in ("BCP_FAULT_MODE", "BCP_FAULT_OPS"):
                os.environ.pop(k, None)
            faults.INJECTOR.reload()
        launches, stats = counts["launches"], counts["stats"]
        verdicts.append(got)
        checks = {
            "equal_oracle": bool(np.array_equal(got, want)),
            f"launched_{entry}": launches[entry] == 1,
            "nothing_else": sum(launches.values()) == 1,
            "no_cpu_fallback": stats["cpu_fallback_sigs"] == 0,
            "no_fault_fallback": stats["fault_fallback_sigs"] == 0,
        }
        rows[site] = {"entry": entry, "launches": launches,
                      "launch_shapes": counts["launch_shapes"],
                      "stats": {k: stats[k] for k in STAT_KEYS},
                      "checks": checks}
    rows["verdicts_equal"] = bool(np.array_equal(*verdicts))
    return rows


def slice_phase(workdir: str, sigs: int = CHAIN_SIGS,
                packed_lanes: int = PACKED_LANES, **gen_kw) -> dict:
    """The validation main paths at the reindex size (see the module
    docstring): the chain generated once, the CPU engine's run, then the
    path under GLV (the default) and under w4 in the order of PATH_ORDER,
    then the drills.
    ``gen_kw`` passes through to sigchain.generate."""
    import numpy as np

    from bitcoincashplus_tpu_torch import native
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.workload import sigchain

    if not native.available():
        raise AssertionError("native library unavailable (native/ build)")
    t0 = time.monotonic()
    gen = sigchain.generate(workdir, sigs, **gen_kw)
    log(f"chain: {gen['blocks']} blocks, {gen['sigs']} sigs, "
        f"{gen['bytes']} bytes, generated in {time.monotonic() - t0:.1f} s")
    recs = sigchain.chain_sig_records(workdir, packed_lanes)
    pub, rs, msg, rn, wrap = E.records_to_blobs(recs)
    msg = msg.copy()
    msg[::1000, 31] ^= 1  # a few lanes that must fail
    blobs = (pub, rs, msg, rn, wrap)
    cpu_packed = np.asarray(native.ecdsa_verify_batch_blobs(
        pub.tobytes(), rs.tobytes(), msg.tobytes(), len(msg)), bool)
    _cs_cpu, cpu = sigchain.validate_chain(workdir, "cpu", depth=1)
    runs = [path_run(workdir, gen, blobs, cpu, cpu_packed,
                     None if kern == "glv" else kern)
            for kern in PATH_ORDER]
    return {"gen": {k: v for k, v in gen.items() if "tip" not in k},
            "cpu": {k: cpu[k] for k in ("digest", "best", "wall_s")},
            "runs": runs, "drills": drill_phase(),
            "tips": (gen["tampered_tip"], gen["good_tip"])}


# ---- the sweep kernels ------------------------------------------------------

def _chunk3_schedule_ops(upto: int) -> tuple:
    """(ALU-pipe, add) instructions of the second hash's schedule words
    16..upto-1 in csrc/sha256d_sweep.cu: words 8..15 are constants (PAD,
    six zeros, the length), so a zero term vanishes and constant terms
    fold into one; a sigma of a variable is 4 ALU instructions (3 shifts
    or funnel shifts and one LOP3), and n terms need n // 2 IADD3."""
    kind = {i: "v" for i in range(8)}
    kind.update({8: "c", 15: "c", **{i: "z" for i in range(9, 15)}})
    alu = adds = 0
    for i in range(16, upto):
        const = n_var = 0
        for src, sigma in ((i - 16, False), (i - 15, True), (i - 7, False),
                           (i - 2, True)):
            if kind[src] == "c":
                const = 1
            elif kind[src] == "v":
                n_var += 1
                alu += 4 if sigma else 0
        adds += (n_var + const) // 2
        kind[i] = "v"
    return alu, adds


def sweep_ops_per_nonce(exact: bool) -> dict:
    """The 32-bit integer instructions a nonce needs in the kernel's rounds
    (csrc/sha256d_sweep.cu), counted the way the card executes them, split
    by pipe. ALU-pipe only: a sigma is 3 shifts or funnel shifts and one
    three-input XOR (LOP3), Ch and Maj one LOP3 each, a byte swap one PRMT,
    a compare one ISETP — a round is Sigma1 + Ch + Sigma0 + Maj = 10. Adds
    (a three-term add is one IADD3; a round's t1, a and e are 4) may issue
    on the FMA pipe as IMAD instead."""
    sig, rnd_alu, rnd_add = 4, 10, 4
    s_alu, s_add = _chunk3_schedule_ops(64 if exact else 61)
    # chunk 2: bswap of the nonce; schedule sigmas v18 (s0), v20..32 (s1,
    # 13) and W33..63 (s0 + s1, 31 words); rounds 4..63
    alu = 1 + (1 + 13 + 2 * 31) * sig + 60 * rnd_alu
    # its adds: W18, W19; W20..32 (11 with a scalar leg) and v25..32 (8);
    # W33..63 (2 each); round 3 (t1, a, e); rounds 4..63; + midstate
    adds = 2 + 11 + 8 + 31 * 2 + 3 + 60 * rnd_add + 8
    # chunk 3: round 0 from the IV folds to 3 adds
    alu += s_alu
    adds += s_add + 3
    if exact:
        alu += 63 * rnd_alu + 8 + 1 + 7 * 2    # bswaps, le256 compares
        adds += 63 * rnd_add + 8               # + IV
    else:
        # rounds 1..56; the e-chain of 57..59 and round 60's t1 (Sigma1 +
        # Ch); bswap and compare of h7
        alu += 56 * rnd_alu + 4 * (sig + 1) + 2
        adds += 56 * rnd_add + 3 * 3 + 2 + 1   # t1 + e, t1_60, h7
    return {"alu": alu, "adds": adds, "total": alu + adds}


# instructions only the integer ALU pipe executes (IADD3 may issue there
# too, and IMAD on the FMA pipe)
W4_KERNELS = ("w4_verify_bytes_kernel", "w4_verify_planes_kernel",
              "w4_field_selftest_kernel")
SWEEP_KERNELS = ("sweep_h7_kernel", "sweep_exact_kernel")
GLV_PAIR_KERNELS = ("glv_dev_verify_pair_kernel", "glv_verify_pair_kernel")
GLV_KERNELS = ("glv_dev_verify_kernel", "glv_verify_kernel",
               "glv_decompose_kernel", "glv_field_chain_kernel") \
    + GLV_PAIR_KERNELS
BATCH_KERNELS = ("sha256d_headers_kernel", "sha256d_pairs_kernel",
                 "merkle_tree_kernel", "sha256d_chain_kernel",
                 "sha256_round_path_kernel")
MSM_KERNELS = ("msm_split_kernel", "msm_buckets_kernel", "msm_merge_kernel",
               "msm_reduce_kernel", "msm_combine_kernel")
LADDER_KERNELS = ("ladder_verify_kernel",)
_ALU_ONLY = ("SHF", "SHL", "SHR", "LOP3", "PRMT", "ISETP")
_NOT_ALU = {"BRA", "EXIT", "BAR", "LDS", "LDG", "STS", "STG", "ATOMG",
            "ATOM", "RED", "S2R", "NOP", "BSSY", "BSYNC", "WARPSYNC", "LDC",
            "CS2R", "CALL", "RET", "YIELD", "MEMBAR", "CCTL", "MOV"}


def _kernel_key(name: str) -> str:
    """A mangled kernel name -> the name of W4_KERNELS, GLV_KERNELS,
    SWEEP_KERNELS, BATCH_KERNELS, MSM_KERNELS or LADDER_KERNELS it holds,
    ``kernel<T>`` for a template instance (the name itself when it holds
    none)."""
    import re

    key = next((k for k in W4_KERNELS + GLV_KERNELS + SWEEP_KERNELS
                + BATCH_KERNELS + MSM_KERNELS + LADDER_KERNELS if k in name),
               None)
    t = key and re.search(key + r"IL[ib](\d+)E", name)
    return f"{key}<{t.group(1)}>" if t else (key or name)


def ptxas_report(log_text: str) -> dict:
    """Per kernel, from nvcc's ``-Xptxas -v`` output: registers, stack
    frame bytes and spill store / load bytes. Template instances are named
    ``kernel<T>``."""
    import re

    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)", line)
        if m:
            fn = _kernel_key(m.group(1))
            out.setdefault(fn, {"registers": None, "stack": 0,
                                "spill_stores": 0, "spill_loads": 0})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def sass_counts(lib: str, kernels: tuple) -> dict | None:
    """Opcode counts of each kernel of a built library whose mangled name
    holds one of ``kernels`` (``cuobjdump -sass``; one entry per name, a
    template's instances summed apart by their mangled names), or None
    where the toolkit has no cuobjdump. The sweeps' nonce loop is not
    unrolled, so a sweep kernel's instructions are one nonce's hash plus
    the loop's own few."""
    import collections
    import re

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            cur = None
            if any(k in name for k in kernels):
                cur = _kernel_key(name)
                funcs[cur] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if m and cur:
            funcs[cur][m.group(1)] += 1
    result = {}
    for name, ops in funcs.items():
        integer = sum(n for op, n in ops.items()
                      if op not in _NOT_ALU and not op.startswith("U"))
        result[name] = {"total": sum(ops.values()), "integer": integer,
                        "alu": sum(ops[op] for op in _ALU_ONLY),
                        "local": sum(n for op, n in ops.items()
                                     if op in ("LDL", "STL")),
                        "top": ops.most_common(8)}
    return result


def _h7_limb(header: bytes, nonce: int) -> int:
    from bitcoincashplus_tpu_torch.crypto.hashes import sha256d

    d = sha256d(header[:76] + nonce.to_bytes(4, "little"))
    return int.from_bytes(d[28:32], "little")  # bswap32(h7)


def _pow_hash(header: bytes, nonce: int) -> int:
    from bitcoincashplus_tpu_torch.crypto.hashes import sha256d

    return int.from_bytes(sha256d(header[:76] + nonce.to_bytes(4, "little")),
                          "little")


def sweep_case(entry: str, tile: int, n_tiles: int, seed: int,
               clock_hz: float, ops: dict, device: str = "cuda",
               reps: int = 10) -> dict:
    """One entry at one launch shape: kernel vs plain on the card, (found,
    nonce, tiles_done) exactly equal, at SWEEP_STARTS seeded starts with
    about one candidate a launch, a start straddling 2^32 whose first
    candidate lies past the wrap (a small nonce, below the start) and a
    no-hit launch; candidates host-verified; kernel and plain times on the
    no-hit launch, and the integer-operation bound. (On a CPU device the
    wrapper itself takes the plain version: a rehearsal of the checks.)"""
    import random

    import torch

    from bitcoincashplus_tpu_torch.ops import miner as MI
    from bitcoincashplus_tpu_torch.ops import pallas_sweep as PS
    from bitcoincashplus_tpu_torch.ops import sha256_sweep as SW

    dev = torch.device(device)
    rng = random.Random(seed)
    header = bytes(rng.randrange(256) for _ in range(80))
    tmpl = SW.header_template(header, dev)
    nonces = tile * n_tiles
    exact = entry == "sweep_exact"
    t7_one = max(0, (1 << 32) // nonces - 1)  # ~1 candidate a launch

    def target_of(t7):  # the exact entry's target at h7's odds
        return ((t7 + 1) << 224) - 1 if t7 else 0

    def run(t7, start, plain=False):
        if entry == "sweep_h7":
            fn = SW.sweep_h7_plain if plain else SW.sweep_fast
            return fn(tmpl, t7, start, n_tiles, tile)
        if entry == "sweep_h7_pallas":
            if plain:
                return SW.sweep_h7_plain(tmpl, t7, start, n_tiles, tile)
            return PS.pallas_sweep(tmpl, t7, start, n_tiles,
                                   tile // PS.LANES, n_tiles)
        tgt = MI.target_tensor(target_of(t7), dev)
        fn = MI.sweep_exact_plain if plain else MI.sweep
        return fn(tmpl, tgt, start, n_tiles, tile)

    def check(t7, start):
        got = run(t7, start).tolist()
        ref = run(t7, start, plain=True).tolist()
        if got != ref:
            raise AssertionError(f"{entry} tile={tile} n_tiles={n_tiles} "
                                 f"start={start} t7={t7}: kernel {got}, "
                                 f"plain {ref}")
        found, nonce, tiles = got
        if found:
            ok = (_pow_hash(header, nonce) <= target_of(t7) if exact
                  else _h7_limb(header, nonce) <= t7)
            off = (nonce - start) & 0xFFFFFFFF
            if not ok or tiles != off // tile + 1:
                raise AssertionError(f"{entry}: a false hit {got}")
        elif tiles != n_tiles:
            raise AssertionError(f"{entry}: no hit but tiles {tiles}")
        return got

    def wrapped_start(t7):
        """A start whose launch straddles 2^32 with no candidate below
        2^32: from 2^32 - nonces/2, step past each candidate the plain
        version finds before the wrap. None if the launch then has no
        candidate past it either."""
        start = (1 << 32) - nonces // 2
        while True:
            found, nonce, _ = run(t7, start, plain=True).tolist()
            if not found or nonce == 0xFFFFFFFF:
                return None
            if nonce < start:
                return start
            start = nonce + 1

    starts = [rng.getrandbits(32) for _ in range(SWEEP_STARTS)]
    results = [check(t7_one, st) for st in starts]
    for odds in (1, 2, 4, 8):  # candidates a launch
        t7_wrap = (t7_one + 1) * odds - 1
        wstart = wrapped_start(t7_wrap)
        if wstart is not None:
            break
    else:
        raise AssertionError(f"{entry}: no straddling launch whose first "
                             "candidate lies past 2^32")
    straddle = check(t7_wrap, wstart)
    if not straddle[0] or straddle[1] >= wstart:
        raise AssertionError(f"{entry}: the straddle from {wstart} did not "
                             f"wrap: {straddle}")
    # a no-hit launch: t7 = 0 (exact: target 0) — an h7 candidate there has
    # odds nonces / 2^32; take the first start that has none
    for k in range(4):
        quiet_start = (starts[0] + k * nonces) & 0xFFFFFFFF
        if check(0, quiet_start)[0] == 0:
            break
    else:
        raise AssertionError(f"{entry}: no quiet start for the no-hit launch")
    if dev.type == "cuda":
        ms = time_cuda(lambda: run(0, quiet_start), reps)
    else:
        ms = time_once(lambda: run(0, quiet_start), dev)[0]
    plain_ms = time_once(lambda: run(0, quiet_start, plain=True), dev)[0]
    per_nonce = ops["exact" if exact else "h7"]  # ALU-pipe instructions
    ops_ms = per_nonce * nonces / (SMS * INT_OPS_PER_SM_CLK * clock_hz) * 1e3
    bytes_ms = (4 * 64 + (32 if exact else 0) + 32) / HBM_BYTES_S * 1e3
    return {"tile": tile, "n_tiles": n_tiles, "nonces": nonces, "ms": ms,
            "plain_ms": plain_ms, "ghs": nonces / ms / 1e6,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_per_nonce": per_nonce, "max_abs_err": 0,
            "found": sum(r[0] for r in results), "settings": len(results) + 2,
            "straddle": {"start": wstart, "t7": t7_wrap, "result": straddle}}


def whole_space_case(entry: str, tile: int, clock_hz: float, ops: dict,
                     tries: int = 16, reps: int = 5) -> dict:
    """The exact and h7 engines' own launch, the whole nonce space from
    nonce 0 (2^32 / tile tiles): kernel against plain on the card,
    (found, nonce, tiles_done) exactly equal, at t7 = 31 (one candidate in
    2^27 nonces on average; the exact entry's target at the same odds) on
    the first seeded header whose first candidate lies between 2^26 and
    2^28 — far past sweep_case's 2^25-nonce launches, and affordable for
    the plain version, which stops after the tile holding it. Kernel and
    plain times on this launch; its bound counts the nonces up to and
    including the hit (what these inputs need)."""
    import random

    import torch

    from bitcoincashplus_tpu_torch.ops import miner as MI
    from bitcoincashplus_tpu_torch.ops import sha256_sweep as SW

    dev = torch.device("cuda")
    n_tiles = (1 << 32) // tile
    exact = entry == "sweep_exact"
    t7 = 31
    target = ((t7 + 1) << 224) - 1
    rng = random.Random(tile + 1)
    for _ in range(tries):
        header = bytes(rng.randrange(256) for _ in range(80))
        tmpl = SW.header_template(header, dev)
        tgt = MI.target_tensor(target, dev)

        def run(plain=False, tmpl=tmpl, tgt=tgt):
            if exact:
                fn = MI.sweep_exact_plain if plain else MI.sweep
                return fn(tmpl, tgt, 0, n_tiles, tile)
            fn = SW.sweep_h7_plain if plain else SW.sweep_fast
            return fn(tmpl, t7, 0, n_tiles, tile)

        found, nonce, _ = run().tolist()
        if found and 1 << 26 <= nonce < 1 << 28:
            break
    else:
        raise AssertionError(f"{entry}: no header with its first candidate "
                             "between 2^26 and 2^28")
    plain_ms, ref = time_once(lambda: run(plain=True).tolist(), dev)
    got = run().tolist()
    if got != ref:
        raise AssertionError(f"{entry} tile={tile} x {n_tiles}: kernel "
                             f"{got}, plain {ref}")
    found, nonce, tiles = got
    ok = (_pow_hash(header, nonce) <= target if exact
          else _h7_limb(header, nonce) <= t7)
    if not ok or tiles != nonce // tile + 1:
        raise AssertionError(f"{entry}: a false hit {got}")
    ms = time_cuda(run, reps)
    need = nonce + 1
    per_nonce = ops["exact" if exact else "h7"]
    ops_ms = per_nonce * need / (SMS * INT_OPS_PER_SM_CLK * clock_hz) * 1e3
    bytes_ms = (4 * 64 + (32 if exact else 0) + 32) / HBM_BYTES_S * 1e3
    return {"tile": tile, "n_tiles": n_tiles, "nonces": need, "ms": ms,
            "plain_ms": plain_ms, "ghs": need / ms / 1e6,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "max_abs_err": 0, "result": got}


def full_launch(entry: str, tile: int, clock_hz: float, ops: dict,
                tries: int = 8, reps: int = 2) -> dict:
    """Kernel time of a no-hit launch of the whole nonce space (2^32
    nonces, as the exact and h7 engines launch at difficulty 1). The
    exact entry at target 0 never hits; the h7 entry at t7 = 0 meets a
    candidate about once in 2^32 nonces, so seeded headers are tried
    until one has none. No plain time: the plain version would take
    minutes for 2^32 nonces."""
    import random

    import torch

    from bitcoincashplus_tpu_torch.ops import miner as MI
    from bitcoincashplus_tpu_torch.ops import sha256_sweep as SW

    n_tiles = (1 << 32) // tile
    rng = random.Random(tile)
    for _ in range(tries):
        header = bytes(rng.randrange(256) for _ in range(80))
        tmpl = SW.header_template(header, "cuda")
        tgt = MI.target_tensor(0, "cuda")

        def run(tmpl=tmpl, tgt=tgt):
            if entry == "sweep_exact":
                return MI.sweep(tmpl, tgt, 0, n_tiles, tile)
            return SW.sweep_fast(tmpl, 0, 0, n_tiles, tile)

        if run().tolist() == [0, 0, n_tiles]:
            break
    else:
        raise AssertionError(f"{entry}: no header without a candidate")
    ms = time_cuda(run, reps)
    torch.cuda.synchronize()
    per_nonce = ops["exact" if entry == "sweep_exact" else "h7"]
    bound = per_nonce * (1 << 32) / (SMS * INT_OPS_PER_SM_CLK * clock_hz) * 1e3
    return {"tile": tile, "n_tiles": n_tiles, "nonces": 1 << 32, "ms": ms,
            "plain_ms": None, "ghs": (1 << 32) / ms / 1e6,
            "bound_ms": bound, "bound_by": "operations"}


def genesis_phase(window: int = GENESIS_WINDOW) -> dict:
    """A known answer: the mainnet genesis header at target 0x1d00ffff,
    swept by each entry's host loop over ``window`` nonces ending at its
    nonce. The three agree, the host verifies the nonce, and it is the
    genesis nonce unless the window holds an earlier hit (printed).
    (``window``, and mining_phase's arguments, let the phase rehearse on
    the CPU device at a small size.)"""
    nonce = GENESIS_NONCE
    from bitcoincashplus_tpu_torch.consensus.params import main_params
    from bitcoincashplus_tpu_torch.consensus.pow import compact_to_target
    from bitcoincashplus_tpu_torch.ops import miner as MI
    from bitcoincashplus_tpu_torch.ops import pallas_sweep as PS
    from bitcoincashplus_tpu_torch.ops import sha256_sweep as SW

    header = main_params().genesis.header.with_nonce(0).serialize()
    target, _ = compact_to_target(DIFF1_BITS)
    start = nonce - window + 1
    found = {}
    for name, fn in (
            ("sweep_exact", lambda: MI.sweep_header(
                header, target, start, window, tile=1 << 16)),
            ("sweep_h7", lambda: SW.sweep_header_fast(
                header, target, start, window, tile=1 << 20)),
            ("sweep_h7_pallas", lambda: PS.sweep_header_pallas(
                header, target, start, window))):
        t0 = time.monotonic()
        found[name] = (*fn(), time.monotonic() - t0)
    nonces = {v[0] for v in found.values()}
    if len(nonces) != 1 or None in nonces:
        raise AssertionError(f"genesis window: entries disagree {found}")
    got = nonces.pop()
    if _pow_hash(header, got) > target:
        raise AssertionError(f"genesis window: {got} fails the host check")
    if got != nonce:
        log(f"genesis window: an earlier hit at {got} (host-verified)")
    return {"nonce": got, "start": start, "window": window,
            "entries": {k: {"hashes": v[1], "s": v[2]}
                        for k, v in found.items()}}


def _pallas_engine(header80, target, start_nonce=0, max_nonces=1 << 32,
                   tile=None):
    """sweep_header_pallas at the sweep_header signature (its tile is the
    Pallas contract's 64 x 128 lanes; ``tile`` is ignored)."""
    from bitcoincashplus_tpu_torch.ops import pallas_sweep as PS

    return PS.sweep_header_pallas(header80, target, start_nonce, max_nonces)


def mining_phase(workdir: str, network: str = "test",
                 blocks: dict = MINING_BLOCKS, max_tries: int = MAX_TRIES,
                 tiles: tuple = (1 << 16, 1 << 20, 1 << 16)) -> dict:
    """The mining main path: generate_blocks on an on-disk ChainstateManager
    of ``network`` (testnet: difficulty 1, nBits 0x1d00ffff) with each
    engine in turn — exact (the supervised default), h7, pallas-h7 and
    resident-h7 — the launch counts zeroed just before each engine and
    read just after. ``tiles``: (exact, h7, resident) tiles."""
    from bitcoincashplus_tpu_torch.consensus.params import select_params
    from bitcoincashplus_tpu_torch.consensus.pow import compact_to_target
    from bitcoincashplus_tpu_torch.mining.generate import generate_blocks
    from bitcoincashplus_tpu_torch.mining.resident import ResidentSweep
    from bitcoincashplus_tpu_torch.ops import dispatch
    from bitcoincashplus_tpu_torch.ops import sha256_sweep as SW
    from bitcoincashplus_tpu_torch.store.blockstore import BlockStore
    from bitcoincashplus_tpu_torch.store.chainstatedb import (BlockIndexDB,
                                                              CoinsDB)
    from bitcoincashplus_tpu_torch.store.kvstore import KVStore
    from bitcoincashplus_tpu_torch.validation.chainstate import \
        ChainstateManager

    params = select_params(network)
    net = os.path.join(workdir, network)
    os.makedirs(os.path.join(net, "blocks"), exist_ok=True)
    kvs = [KVStore(os.path.join(net, "blocks", "index.sqlite")),
           KVStore(os.path.join(net, "chainstate.sqlite"))]
    store = BlockStore(net, params.netmagic)
    cs = ChainstateManager(params, CoinsDB(kvs[1]), store,
                           script_verifier=None, index_db=BlockIndexDB(kvs[0]))
    cs.load_block_index()
    spk = bytes.fromhex("76a914") + bytes(range(20)) + bytes.fromhex("88ac")
    t_exact, t_h7, t_res = tiles
    resident = ResidentSweep(tile=t_res, seg_tiles=8, inflight=2,
                             kernel="h7")
    engines = {
        "exact": (dispatch.supervised_sweep(), t_exact, "sweep_exact"),
        "h7": (dispatch.supervised_sweep(inner=SW.sweep_header_fast), t_h7,
               "sweep_h7"),
        "pallas-h7": (dispatch.supervised_sweep(inner=_pallas_engine),
                      t_exact, "sweep_h7_pallas"),
        "resident-h7": (dispatch.supervised_resident_sweep(resident), t_res,
                        "sweep_h7"),
    }
    dispatch.reset()
    rows, mined = {}, []
    try:
        for name, (sweep, tile, entry) in engines.items():
            swept = [0]

            def counted(header80, target, start_nonce=0,
                        max_nonces=1 << 32, tile=None, _sweep=sweep):
                nonce, hashes = _sweep(header80, target, start_nonce,
                                       max_nonces, tile)
                swept[0] += hashes
                return nonce, hashes

            height0 = cs.tip().height
            SW.reset_launch_counts()
            t0 = time.monotonic()
            hashes = generate_blocks(cs, spk, blocks[name], max_tries,
                                     tile=tile, sweep=counted)
            wall = time.monotonic() - t0
            launches = dict(SW.LAUNCHES)
            bits, ok = [], []
            for h in hashes:
                hdr = cs.block_index[h].header
                bits.append(hdr.bits)
                ok.append(_pow_hash(hdr.serialize(), hdr.nonce)
                          <= compact_to_target(hdr.bits)[0]
                          and cs.block_index[h] in cs.chain)
            mined += [cs.block_index[h].header.serialize() for h in hashes]
            rows[name] = {
                "blocks": len(hashes), "height": cs.tip().height,
                "connected": cs.tip().height - height0 == blocks[name]
                and len(hashes) == blocks[name] and all(ok),
                "bits": sorted({f"{b:#010x}" for b in bits}),
                "hashes": swept[0], "wall_s": wall,
                "ghs": swept[0] / wall / 1e9, "entry": entry,
                "tile": tile, "launches": launches}
        fallbacks = dispatch.breaker("miner").snapshot()["fallback_calls"]
        cs.flush()
    finally:
        resident.close()
        store.close()
        for kv in kvs:
            kv.close()
    return {"engines": rows, "fallbacks": fallbacks,
            "height": sum(r["blocks"] for r in rows.values()),
            "resident": resident.snapshot(), "headers": mined}


# ---- the batch SHA-256d kernels (K1, K2) ------------------------------------

def compress_ops(kinds: str, iv_state: bool) -> tuple:
    """(ALU-pipe, add) instructions of one compression in
    csrc/sha256d_batch.cu for a block whose 16 words are ``kinds`` (v a
    variable, c a constant, z zero), counted as sweep_ops_per_nonce counts:
    a schedule word's sigma of a variable is 4 ALU instructions (a sigma of
    a constant folds) and its n terms need n // 2 IADD3; a round is 10 ALU
    and 4 adds, round 0 from the IV 3 adds; the state add 8."""
    kind = dict(enumerate(kinds))
    alu = adds = 0
    for i in range(16, 64):
        const = n_var = 0
        for src, sigma in ((i - 16, False), (i - 15, True), (i - 7, False),
                           (i - 2, True)):
            if kind[src] == "c":
                const = 1
            elif kind[src] == "v":
                n_var += 1
                alu += 4 if sigma else 0
        if n_var:
            adds += (n_var + const) // 2
        kind[i] = "v" if n_var else ("c" if const else "z")
    alu += (63 if iv_state else 64) * 10
    adds += 63 * 4 + (3 if iv_state else 4) + 8
    return alu, adds


def batch_ops() -> dict:
    """ALU-pipe and add instructions of each batch entry's unit of work:
    a header (sha256d_80: block 1, block 2 with the padding, the second
    hash), its compare (8 byte swaps, 15 compares), and a pair
    (sha256d_64: block 1, the constant padding block, the second hash)."""
    second = compress_ops("v" * 8 + "c" + "z" * 6 + "c", True)
    header = [compress_ops("v" * 16, True),
              compress_ops("v" * 4 + "c" + "z" * 10 + "c", False), second]
    pair = [compress_ops("v" * 16, True),
            compress_ops("c" + "z" * 14 + "c", False), second]
    out = {}
    for name, parts, extra in (("header", header, 0), ("pow", header, 23),
                               ("pair", pair, 0)):
        alu = sum(a for a, _ in parts) + extra
        adds = sum(b for _, b in parts)
        out[name] = {"alu": alu, "adds": adds, "total": alu + adds,
                     "compressions": [a + b for a, b in parts]}
    return out


def ops_ms(alu: int, clock_hz: float) -> float:
    return alu / (SMS * INT_OPS_PER_SM_CLK * clock_hz) * 1e3


def bound(alu: int, nbytes: int, clock_hz: float) -> dict:
    o, b = ops_ms(alu, clock_hz), nbytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(o, b), "bound_by": "operations" if o >= b
            else "bytes"}


def batch_bound(alu: int, nbytes: int, rounds: int, issue_instr: int,
                round_ms: float, clock_hz: float) -> dict:
    """bound() with a third term for the batch kernels, the dependent
    path: the longest thread's chain of rounds (a thread's hash, or the
    tree's dependent hashes, 192 rounds each) x one round's e -> e' path
    as sha256_round_path measures it alone. The largest of the three;
    bound_of says which set it. Beside it and not in it, this design's
    issue floor: the longest thread's instructions at one a clock (a floor
    of one thread a hash, not of the function)."""
    card = bound(alu, nbytes, clock_hz)
    path_ms = rounds * round_ms
    extra = {"card_bound_ms": card["bound_ms"], "path_bound_ms": path_ms,
             "issue_floor_ms": issue_instr / clock_hz * 1e3}
    if path_ms >= card["bound_ms"]:
        return {"bound_ms": path_ms, "bound_by": "operations",
                "bound_of": "dependent path", **extra}
    return {**card, "bound_of": "card", **extra}


def round_path(clock_hz: float, seed: int = 14) -> dict:
    """The dependent path of one SHA-256 round on the card: the entry
    sha256_round_path (one thread, 64 rounds a step of e' = K[i] + S1(e)
    + Ch(e, f, g)) timed at two step counts, the difference over the
    rounds between them; its result equal to a Python model's."""
    import ctypes

    import torch

    from bitcoincashplus_tpu_torch.crypto.hashes import SHA256_K

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF

    vp = ctypes.c_void_p
    rng = random.Random(seed)
    efg = [rng.getrandbits(32) for _ in range(3)]
    x = _u32_tensor(efg, "cuda")
    out = torch.empty(3, dtype=torch.int32, device="cuda")
    steps = (1024, 3072)
    times = {n: time_cuda(entry_call(
        "sha256_round_path", [vp, ctypes.c_int, vp, vp], x.data_ptr(), n,
        out.data_ptr()), 5) for n in steps}
    e, f, g = efg
    for _ in range(steps[1]):
        for k in SHA256_K:
            s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
            e, f, g = (k + s1 + (g ^ (e & (f ^ g)))) & 0xFFFFFFFF, e, f
    if [int(w) & 0xFFFFFFFF for w in out.cpu()] != [e, f, g]:
        raise AssertionError("sha256_round_path differs from its model")
    round_ms = (times[steps[1]] - times[steps[0]]) / (
        64 * (steps[1] - steps[0]))
    return {"round_ms": round_ms, "cycles_a_round": round_ms * 1e-3 *
            clock_hz, "times_ms": times}


def hash_chain(clock_hz: float, seed: int = 13) -> dict:
    """The latency of one dependent sha256d_64 (3 compressions) on the
    card: the entry sha256d_chain (one thread) timed at two chain lengths,
    the difference over the steps between them; its result equal to
    hashlib's chain."""
    import ctypes
    import hashlib
    import struct

    import torch

    vp = ctypes.c_void_p
    rng = random.Random(seed)
    seed_words = [rng.getrandbits(32) for _ in range(8)]
    x = _u32_tensor(seed_words, "cuda")
    out = torch.empty(8, dtype=torch.int32, device="cuda")
    times = {steps: time_cuda(entry_call(
        "sha256d_chain", [vp, ctypes.c_int, vp, vp], x.data_ptr(), steps,
        out.data_ptr()), 5) for steps in (1024, 3072)}
    d = struct.pack(">8I", *seed_words)
    for _ in range(3072):
        d = hashlib.sha256(hashlib.sha256(d + d).digest()).digest()
    got = struct.pack(">8I", *(int(w) & 0xFFFFFFFF for w in out.cpu()))
    if got != d:
        raise AssertionError("sha256d_chain differs from hashlib's chain")
    step_ms = (times[3072] - times[1024]) / 2048
    return {"step_ms": step_ms, "cycles_a_step": step_ms * 1e-3 * clock_hz,
            "times_ms": times}


def _u32_tensor(a, dev):
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32)).to(dev)


def header_case(B: int, seed: int, clock_hz: float, ops: dict,
                step_ms: float, round_ms: float, reps: int = 50) -> dict:
    """sha256d_headers and check_headers_pow at B seeded headers (lane 0
    the mainnet genesis header) against their plain versions on the card,
    exactly equal; the digests against hashlib and the verdicts against
    Python's compare, at a target equal to lane 1's hash (it passes) and
    one below it (it fails), and at difficulty 1. The kernels' device
    times (time_device, the C entries called directly), the wrapper's
    time a call, the plain times, the bound and the chain floor (one
    thread's sha256d)."""
    import hashlib

    import numpy as np
    import torch

    from bitcoincashplus_tpu_torch.consensus.params import main_params
    from bitcoincashplus_tpu_torch.consensus.pow import compact_to_target
    from bitcoincashplus_tpu_torch.ops import sha256 as SH

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    headers = rng.integers(0, 256, (B, 80), dtype=np.uint8)
    headers[0] = np.frombuffer(main_params().genesis.header.serialize(),
                               np.uint8)
    want = [hashlib.sha256(hashlib.sha256(h.tobytes()).digest()).digest()
            for h in headers]
    words = _u32_tensor(SH.headers_to_words_np(headers), dev)
    got = SH.sha256d_headers_words(words)
    if not torch.equal(got, SH.sha256d_headers_plain(words)):
        raise AssertionError(f"sha256d_headers B={B}: kernel != plain")
    got_bytes = SH.digests_to_bytes(list(got.cpu().numpy()
                                         .view(np.uint32).T))
    if [g.tobytes() for g in got_bytes] != want:
        raise AssertionError(f"sha256d_headers B={B}: != hashlib")
    values = [int.from_bytes(d, "little") for d in want]
    for target in (values[1], values[1] - 1, compact_to_target(DIFF1_BITS)[0]):
        tgt = _u32_tensor(SH.target_to_limbs_np(target), dev)
        kd, ko = SH.check_headers_pow_words(words, tgt)
        pd, po = SH.check_headers_pow_plain(words, tgt)
        if not (torch.equal(kd, pd) and torch.equal(ko, po)
                and torch.equal(kd, got)):
            raise AssertionError(f"check_headers_pow B={B}: kernel != plain")
        if ko.cpu().tolist() != [v <= target for v in values]:
            raise AssertionError(f"check_headers_pow B={B}: != the compare")
    out = torch.empty((B, 8), dtype=torch.int32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    ms = time_device(entry_call(
        "sha256d_headers", SH.ENTRY_ARGS["sha256d_headers"],
        words.data_ptr(), B, out.data_ptr()), clock_hz, reps)
    pow_ms = time_device(entry_call(
        "check_headers_pow", SH.ENTRY_ARGS["check_headers_pow"],
        words.data_ptr(), B, tgt.data_ptr(), out.data_ptr(), ok.data_ptr()),
        clock_hz, reps)
    wrapper_ms = time_cuda(lambda: SH.sha256d_headers_words(words), reps)
    plain_ms = time_once(lambda: SH.sha256d_headers_plain(words), dev)[0]
    pow_plain_ms = time_once(lambda: SH.check_headers_pow_plain(words, tgt),
                             dev)[0]
    return {"B": B, "ms": ms, "plain_ms": plain_ms, "pow_ms": pow_ms,
            "pow_plain_ms": pow_plain_ms, "wrapper_ms": wrapper_ms,
            "max_abs_err": 0,
            **batch_bound(B * ops["header"]["alu"], B * (80 + 32), 192,
                          ops["header"]["total"], round_ms, clock_hz),
            "pow_bound": batch_bound(B * ops["pow"]["alu"],
                                     B * (80 + 32 + 1) + 32, 192,
                                     ops["pow"]["total"], round_ms,
                                     clock_hz),
            "chain_floor_ms": step_ms}


def tree_plan(n_levels: int) -> list:
    """The merkle_tree entry's launches, (levels a block, blocks, threads,
    top) each, from the leaves up: top -1 for a chained launch of
    TREE_LEVELS levels a block (trees above 2 * TREE_LEVELS levels), 0 for
    a one-block launch, else the levels the block that draws the last
    ticket reduces above the others (at most 2^TREE_BLOCKS_LOG2 blocks, of
    at least TREE_LEVELS levels) in the same launch."""
    from bitcoincashplus_tpu_torch.ops.merkle import (TREE_BLOCKS_LOG2,
                                                      TREE_LEVELS)

    plan, left = [], n_levels
    while True:
        if left <= TREE_LEVELS:
            lv, top = left, 0
        elif left <= 2 * TREE_LEVELS:
            lv = max(TREE_LEVELS, left - TREE_BLOCKS_LOG2)
            top = left - lv
        else:
            lv, top = TREE_LEVELS, -1
        plan.append((lv, 1 << (left - lv), 1 << (lv - 1), top))
        if top >= 0:
            return plan
        left -= lv


def tree_work(bucket: int, m: int) -> tuple:
    """(pair hashes, dependent hash steps) a tree of ``m`` live leaves
    needs in the kernel: the live pairs of each level (pair 0 at least,
    the witness), and the longest chain of sha256d_64 one thread computes
    (a level's pairs over the block's threads, for the levels with m > 1,
    the last block's top levels included; the first level's pair 0 when
    m <= 1)."""
    pairs = steps = 0
    mm = m
    for lv, _blocks, threads, top in tree_plan(bucket.bit_length() - 1):
        S = 1 << (lv - 1)
        widths = [S >> j for j in range(lv)] + \
            [(1 << (top - 1)) >> j for j in range(max(top, 0))]
        for width in widths:
            if mm > 1:
                pairs += (mm + 1) // 2
                steps += -(-width // threads)
                mm = (mm + 1) // 2
            elif pairs == 0:
                pairs = steps = 1
    return pairs, steps


TREE_BUCKETS = (128, 512, 1024, 4096, 8192, 1 << 16, 1 << 17)
HEADER_SHAPES = (16, 17, 2048, 16384)
PAIR_SHAPES = (128, 512, 1000, 1 << 16)


def tree_case(bucket: int, seed: int, clock_hz: float, ops: dict,
              step_ms: float, round_ms: float, reps: int = 50) -> dict:
    """merkle_tree at one bucket, against its plain version on the card
    (root, mutated and witness exactly equal) and the host oracles
    (compute_merkle_root and merkle_root_naive on the live leaves; the
    witness sha256d(h0 || h1)), at live counts: the bucket (pow2), an odd
    count, bucket / 2 + 1, a duplicated tail (mutated), equal pairs past m
    (not mutated), and 2; above 2^16 leaves (chained launches: each
    lower launch's roots carry their subtrees' `mutated` words up) the
    bucket, the duplicated tail and the equal pairs only. The wrapper's
    ticket counter is 0 after every case. Times at m = bucket: the
    kernel's device time (time_device, the C entry called directly; the
    same with the ticket counter zeroed before each call, the choice the
    kernel's self-reset avoids), the wrapper's time a call (merkle_tree)
    and the host API's (compute_merkle_root_tpu_ex: the leaves' copy in,
    the launch, the one copy out and the host's witness check), the plain
    time, the bound (the live pairs over the card, or the longest
    thread's dependent hashes x 192 rounds x one round's measured
    dependent path), this design's issue floor (those hashes' instructions
    at one a clock), and the chain floor (those hashes x one hash's
    measured latency)."""
    import hashlib

    import numpy as np
    import torch

    from bitcoincashplus_tpu_torch.consensus import merkle as CM
    from bitcoincashplus_tpu_torch.ops import merkle as MK

    dev = torch.device("cuda")
    n_levels = bucket.bit_length() - 1
    plan = tree_plan(n_levels)
    if (len(plan) == 1) != (bucket <= 1 << 16) or any(
            top != -1 for *_, top in plan[:-1]):
        raise AssertionError(f"merkle_tree {bucket}: launch plan {plan}")
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (bucket, 32), dtype=np.uint8)
    odd = bucket * 3 // 4 + 1
    cases = {"pow2": bucket, "odd": odd, "pow2+1": bucket // 2 + 1,
             "dup_tail": odd + 1, "equal_past_m": odd, "m=2": 2}
    if bucket > 1 << 16:
        cases = {k: cases[k] for k in ("pow2", "dup_tail", "equal_past_m")}
    rows = {}
    for label, m in cases.items():
        leaves = base.copy()
        if label == "dup_tail":
            leaves[m - 1] = leaves[m - 2]
        if label == "equal_past_m":
            leaves[m:] = leaves[m - 1]
        hs = [leaves[i].tobytes() for i in range(m)]
        words = _u32_tensor(MK._digests_to_words(leaves), dev)
        k = MK.merkle_tree(words, n_levels, m)
        p = MK.tree_reduce_plain(words, n_levels, m)
        if not (torch.equal(k[0], p[0]) and bool(k[1]) == bool(p[1])
                and torch.equal(k[2], p[2])):
            raise AssertionError(f"merkle_tree {bucket} {label}: kernel != "
                                 f"plain")
        root = MK._words_to_digests(k[0].cpu().numpy().view(np.uint32)
                                    [None])[0].tobytes()
        wit = MK._words_to_digests(k[2].cpu().numpy().view(np.uint32)
                                   [None])[0].tobytes()
        want = CM.compute_merkle_root(hs)
        if (root, bool(k[1])) != want or root != CM.merkle_root_naive(hs) \
                or wit != hashlib.sha256(hashlib.sha256(
                    hs[0] + hs[1]).digest()).digest():
            raise AssertionError(f"merkle_tree {bucket} {label}: != the "
                                 f"host oracles")
        if bool(k[1]) != (label == "dup_tail"):
            raise AssertionError(f"merkle_tree {bucket} {label}: mutated "
                                 f"{bool(k[1])}")
        if int(MK._tickets(dev).item()) != 0:
            raise AssertionError(f"merkle_tree {bucket} {label}: the "
                                 f"ticket counter was left nonzero")
        rows[label] = {"m": m, "mutated": bool(k[1])}
        if label == "pow2":
            nodes = 1 << max(0, n_levels - MK.TREE_LEVELS)
            scratch = torch.empty(2 * nodes * 9, dtype=torch.int32,
                                  device=dev)
            tickets = torch.zeros(1, dtype=torch.int32, device=dev)
            out = torch.empty(MK.TREE_WORDS, dtype=torch.int32, device=dev)
            call = entry_call(
                "merkle_tree", MK.ENTRY_ARGS["merkle_tree"],
                words.data_ptr(), n_levels, m, scratch.data_ptr(), nodes,
                tickets.data_ptr(), out.data_ptr())
            ms = time_device(call, clock_hz, reps)
            if not torch.equal(out[:8], k[0]) or int(tickets.item()) != 0:
                raise AssertionError(f"merkle_tree {bucket}: the timed "
                                     f"launches' root differs or their "
                                     f"ticket counter was left nonzero")

            def zeroed():  # the counter zeroed before every call instead
                tickets.zero_()
                call()
            zeroed_ms = time_device(zeroed, clock_hz, reps)
            wrapper_ms = time_cuda(
                lambda: MK.merkle_tree(words, n_levels, m), reps)
            host_ms = time_cuda(
                lambda: MK.compute_merkle_root_tpu_ex(hs), reps)
            plain_ms = time_once(
                lambda: MK.tree_reduce_plain(words, n_levels, m), dev)[0]
    pairs, steps = tree_work(bucket, bucket)
    return {"bucket": bucket, "ms": ms, "plain_ms": plain_ms,
            "wrapper_ms": wrapper_ms, "host_api_ms": host_ms,
            "zeroed_ms": zeroed_ms, "max_abs_err": 0, "cases": rows,
            "launch_plan": plan,
            **batch_bound(pairs * ops["pair"]["alu"], bucket * 32 + 68,
                          steps * 192, steps * ops["pair"]["total"],
                          round_ms, clock_hz),
            "pair_hashes": pairs, "chain_steps": steps,
            "chain_floor_ms": steps * step_ms}


def pairs_case(n: int, seed: int, clock_hz: float, ops: dict,
               step_ms: float, round_ms: float, reps: int = 50) -> dict:
    """The sha256d_pairs entry (hash_pairs_words) at n seeded rows against
    its plain version on the card and hashlib, exactly equal; the
    kernel's device time (time_device), the wrapper's, the plain time and
    the bound."""
    import hashlib

    import numpy as np
    import torch

    from bitcoincashplus_tpu_torch.ops import merkle as MK

    dev = torch.device("cuda")
    rows = np.random.default_rng(seed).integers(0, 1 << 32, (n, 16),
                                                dtype=np.uint64)
    words = _u32_tensor(rows.astype(np.uint32), dev)
    got = MK.hash_pairs_words(words)
    if not torch.equal(got, MK.hash_pairs_plain(words)):
        raise AssertionError(f"sha256d_pairs n={n}: kernel != plain")
    raw = rows.astype(">u4").tobytes()
    want = b"".join(hashlib.sha256(hashlib.sha256(
        raw[64 * i:64 * i + 64]).digest()).digest() for i in range(n))
    if got.cpu().numpy().view(np.uint32).astype(">u4").tobytes() != want:
        raise AssertionError(f"sha256d_pairs n={n}: != hashlib")
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    ms = time_device(entry_call(
        "sha256d_pairs", MK.ENTRY_ARGS["sha256d_pairs"], words.data_ptr(), n,
        out.data_ptr()), clock_hz, reps)
    wrapper_ms = time_cuda(lambda: MK.hash_pairs_words(words), reps)
    plain_ms = time_once(lambda: MK.hash_pairs_plain(words), dev)[0]
    return {"N": n, "ms": ms, "plain_ms": plain_ms, "wrapper_ms": wrapper_ms,
            "max_abs_err": 0,
            **batch_bound(n * ops["pair"]["alu"], n * 96, 192,
                          ops["pair"]["total"], round_ms, clock_hz),
            "chain_floor_ms": step_ms}


def _batch_counts_zero() -> None:
    from bitcoincashplus_tpu_torch.ops import merkle as MK
    from bitcoincashplus_tpu_torch.ops import sha256 as SH

    _zero_counts()
    MK.reset_launch_counts()
    SH.reset_launch_counts()


def _batch_counts() -> dict:
    from bitcoincashplus_tpu_torch.ops import dispatch
    from bitcoincashplus_tpu_torch.ops import merkle as MK
    from bitcoincashplus_tpu_torch.ops import sha256 as SH

    snap = dispatch.snapshot()
    return {**MK.LAUNCHES, **SH.LAUNCHES,
            "fallbacks": {site: snap.get(site, {}).get("fallback_calls", 0)
                          for site in ("merkle", "sha256")}}


class HostMerkleCount:
    """Counts calls of the host consensus.merkle.compute_merkle_root (the
    module attribute that ops/dispatch.merkle_root and ops/merkle import
    at call time) by leaf count, while it is installed."""

    def __init__(self):
        from bitcoincashplus_tpu_torch.consensus import merkle as CM

        self.mod, self.real, self.calls = CM, CM.compute_merkle_root, []

    def __enter__(self):
        def counted(hashes):
            self.calls.append(len(hashes))
            return self.real(hashes)

        self.mod.compute_merkle_root = counted
        return self

    def __exit__(self, *exc):
        self.mod.compute_merkle_root = self.real

    def big(self, floor: int = 512) -> int:
        return sum(n >= floor for n in self.calls)


BIG_CHAIN_SIGS = 13_286       # 3 blocks of 4,095 spends, one of 1,001
BIG_TXS_PER_BLOCK = 4_095     # + the coinbase: 4,096 leaves


def _dummy_block(prev_hash: bytes, n_txs: int, t: int, salt: bytes):
    """A regtest block of a coinbase and n_txs - 1 one-input transactions
    that spend outputs nobody has (valid in form: CheckBlock's Merkle
    rules come before any spend is looked up), its header mined."""
    import hashlib

    from bitcoincashplus_tpu_torch.consensus import merkle as CM
    from bitcoincashplus_tpu_torch.consensus.block import (CBlock,
                                                           CBlockHeader)
    from bitcoincashplus_tpu_torch.consensus.tx import (COutPoint,
                                                        CTransaction, CTxIn,
                                                        CTxOut)

    coinbase = CTransaction(
        version=1, vin=(CTxIn(COutPoint(), b"\x03" + salt[:3] + b"dummy",
                              0xFFFFFFFF),),
        vout=(CTxOut(50, b"\x51"),))
    txs = [coinbase] + [CTransaction(
        version=1, vin=(CTxIn(COutPoint(hashlib.sha256(
            salt + i.to_bytes(4, "little")).digest(), 0), b"", 0xFFFFFFFF),),
        vout=(CTxOut(1000, b"\x51"),)) for i in range(n_txs - 1)]
    root, _ = CM.compute_merkle_root([tx.txid for tx in txs])
    return CBlock(_mine_regtest(CBlockHeader(
        version=0x20000000, hash_prev_block=prev_hash, hash_merkle_root=root,
        time=t, bits=0x207FFFFF)), tuple(txs))


def _mine_regtest(header):
    from bitcoincashplus_tpu_torch.consensus.pow import compact_to_target

    target, _ = compact_to_target(header.bits)
    while int.from_bytes(header.get_hash(), "little") > target:
        header = header.with_nonce(header.nonce + 1)
    return header


def _submit(cs, block) -> str:
    """process_new_block's reject reason for ``block`` ("" if accepted)."""
    from bitcoincashplus_tpu_torch.validation.chainstate import \
        BlockValidationError

    try:
        cs.process_new_block(block)
    except BlockValidationError as e:
        return e.reason
    return ""


def bigblock_phase(workdir: str, sigs: int = BIG_CHAIN_SIGS,
                   txs_per_block: int = BIG_TXS_PER_BLOCK) -> dict:
    """The block-validation main path with big blocks: a regtest chain of
    one-input transactions (workload/sigchain.generate), whose dense blocks
    have 4,096 leaves and a last one 1,002 (odd tails at levels 1, 2 and
    4), read back through a ChainstateManager with
    BlockScriptVerifier(backend="device") under the default GLV kernel,
    counts zeroed just before and read just after: merkle_tree launched
    once for each block of 512 leaves or more, the host compute_merkle_root
    called for none of them, no merkle or sha256 fallback, and the coin
    digest and best block equal to the CPU engine's (which runs with the
    device Merkle gate raised past every block). The Merkle leg's time per
    block is read by wrapping ops/dispatch.block_merkle_root. Then two
    crafted blocks of 1,001 or more leaves on the tip: a duplicated tail
    (rejected bad-txns-duplicate) and an altered header root (rejected
    bad-txnmrklroot), each with one host confirmation."""
    import dataclasses
    import statistics as st

    from bitcoincashplus_tpu_torch.consensus import merkle as CM
    from bitcoincashplus_tpu_torch.consensus.block import CBlock
    from bitcoincashplus_tpu_torch.ops import dispatch
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S
    from bitcoincashplus_tpu_torch.workload import sigchain

    t0 = time.monotonic()
    gen = sigchain.generate(workdir, sigs, inputs_per_tx=1,
                            txs_per_block=txs_per_block)
    gen_s = time.monotonic() - t0
    blocks = list(sigchain.read_blocks(workdir))
    leaves = [len(b.vtx) for b in blocks]
    big = [n for n in leaves if n >= dispatch._merkle_device_min()]
    largest = max(len(b.serialize()) for b in blocks)
    log(f"big-block chain: {gen['blocks']} blocks, {gen['sigs']} sigs, "
        f"{gen['bytes']} bytes, generated in {gen_s:.1f} s; blocks of 512 "
        f"leaves or more: {big}, largest {largest} bytes")
    os.environ["BCP_TPU_MERKLE_MIN"] = str(1 << 40)
    try:
        _cs_cpu, cpu = sigchain.validate_chain(workdir, "cpu", depth=1)
    finally:
        os.environ.pop("BCP_TPU_MERKLE_MIN", None)
    if E.active_kernel() != "glv":
        raise AssertionError(f"the default kernel is {E.active_kernel()}")
    leg = []
    real_leg = dispatch.block_merkle_root

    def timed_leg(block):
        t = time.perf_counter()
        out = real_leg(block)
        leg.append((len(block.vtx), time.perf_counter() - t))
        return out

    dispatch.block_merkle_root = timed_leg
    try:
        _batch_counts_zero()
        with HostMerkleCount() as host:
            t0 = time.monotonic()
            cs, dev = sigchain.validate_chain(workdir, "device",
                                              depth=PIPELINE_DEPTH)
            wall = time.monotonic() - t0
        counts = {**_batch_counts(), **dict(S.LAUNCHES)}
        stats = E.STATS.snapshot()
    finally:
        dispatch.block_merkle_root = real_leg
    big_leg = [s for n, s in leg if n >= 512]

    def median_s(fn, reps=5):
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        return st.median(ts)

    # the same blocks' roots after the run, the card idle: the host loop,
    # and the device leg alone (no signature batch in flight before it)
    host_times, alone_times = [], []
    for b in blocks:
        if len(b.vtx) >= 512:
            hs = [tx.txid for tx in b.vtx]
            root = b.header.hash_merkle_root
            host_times.append(median_s(lambda: CM.compute_merkle_root(hs)))
            alone_times.append(median_s(
                lambda: dispatch.merkle_root(hs, expected=root)))
    # two crafted blocks on the tip
    tip = cs.tip()
    base = _dummy_block(tip.hash, 1001, tip.header.time + 60, b"crafted")
    dup = CBlock(base.header, base.vtx + base.vtx[-1:])
    bad_root = CBlock(_mine_regtest(dataclasses.replace(
        base.header, hash_merkle_root=bytes(31) + b"\x01", nonce=0)),
        base.vtx)
    crafted = {}
    for label, blk in (("duplicated_tail", dup), ("bad_root", bad_root)):
        _batch_counts_zero()
        with HostMerkleCount() as h:
            reason = _submit(cs, blk)
        crafted[label] = {"leaves": len(blk.vtx), "reason": reason,
                          "host_confirmations": h.big(),
                          "merkle_tree": _batch_counts()["merkle_tree"]}
    checks = {
        "digest_equal": dev["digest"] == cpu["digest"],
        "best_equal": dev["best"] == cpu["best"],
        "merkle_tree_per_big_block": counts["merkle_tree"] == len(big) == 4,
        "no_host_merkle_on_big_blocks": host.big() == 0,
        "no_fallback": not any(counts["fallbacks"].values())
        and stats["cpu_fallback_sigs"] == 0,
        "glv_launched": counts["glv_dev_verify"] > 0,
        "odd_tail_block": sorted(set(leaves) & {1002}) == [1002],
        "duplicated_tail_rejected":
            crafted["duplicated_tail"]["reason"] == "bad-txns-duplicate",
        "bad_root_rejected":
            crafted["bad_root"]["reason"] == "bad-txnmrklroot",
        "one_confirmation_each": all(c["host_confirmations"] == 1
                                     and c["merkle_tree"] == 1
                                     for c in crafted.values()),
    }
    return {"blocks": gen["blocks"], "sigs": gen["sigs"],
            "bytes": gen["bytes"], "largest_block": largest, "gen_s": gen_s,
            "big_leaves": big, "wall_s": wall,
            "cpu_wall_s": cpu["wall_s"], "launches": counts,
            "merkle_leg_s": big_leg, "merkle_leg_share": sum(big_leg) / wall,
            "host_merkle_s": host_times, "leg_alone_s": alone_times,
            "crafted": crafted,
            "host_calls": host.calls, "checks": checks}


def regtest_headers(n: int, seed: int = 21) -> list:
    """n mined regtest headers, each on the last."""
    from bitcoincashplus_tpu_torch.consensus.block import CBlockHeader
    from bitcoincashplus_tpu_torch.consensus.params import regtest_params

    params = regtest_params()
    rng = random.Random(seed)
    prev, out = params.genesis.header.get_hash(), []
    for i in range(n):
        h = _mine_regtest(CBlockHeader(
            version=0x20000000, hash_prev_block=prev,
            hash_merkle_root=rng.randbytes(32),
            time=params.genesis.header.time + 60 * (i + 1),
            bits=params.genesis.header.bits))
        out.append(h.serialize())
        prev = h.get_hash()
    return out


def _hashlib_mmr(hs: list) -> bytes:
    import hashlib

    def h2(b):
        return hashlib.sha256(hashlib.sha256(b).digest()).digest()

    def tree(ls):
        return ls[0] if len(ls) == 1 else h2(tree(ls[:len(ls) // 2])
                                              + tree(ls[len(ls) // 2:]))

    peaks, pos, n = [], 0, len(hs)
    for bit in range(n.bit_length() - 1, -1, -1):
        if n & (1 << bit):
            peaks.append(tree(hs[pos:pos + (1 << bit)]))
            pos += 1 << bit
    acc = peaks[-1]
    for p in reversed(peaks[:-1]):
        acc = h2(p + acc)
    return acc


def headers_phase(mined: list, n: int = 2000) -> dict:
    """The header PoW batch and the certificate MMR (counts zeroed just
    before each run, read just after): a 2,000-header regtest chain (a
    full `headers` message) through consensus/pow.check_headers_pow_batch,
    verdicts equal to per-header check_proof_of_work, one sha256d_headers
    launch at B = 2048; again with one header at nBits 0x1d00ffff whose
    nonce misses (its lane False, confirmed on the host once) and the
    mining phase's testnet difficulty-1 headers; then store/certificate.
    mmr_root over the chain's header hashes against a hashlib MMR, one
    sha256d_pairs launch for each MMR level of 128 pairs or more."""
    from bitcoincashplus_tpu_torch.consensus.block import CBlockHeader
    from bitcoincashplus_tpu_torch.consensus.params import regtest_params
    from bitcoincashplus_tpu_torch.consensus.pow import (
        check_headers_pow_batch, check_proof_of_work, compact_to_target)
    from bitcoincashplus_tpu_torch.crypto import hashes
    from bitcoincashplus_tpu_torch.store import certificate
    from bitcoincashplus_tpu_torch.util import devicewatch as dw

    params = regtest_params().consensus
    chain = regtest_headers(n)
    miss = CBlockHeader(version=1, hash_merkle_root=b"\x22" * 32,
                        time=1_700_000_000, bits=DIFF1_BITS, nonce=3)
    if int.from_bytes(miss.get_hash(), "little") <= \
            compact_to_target(DIFF1_BITS)[0]:
        raise AssertionError("the missing header hits")
    runs = {}
    for label, batch in (("chain", chain),
                         ("miss_and_mined", chain[:1234] + [miss.serialize()]
                          + chain[1235:] + list(mined))):
        want = [check_proof_of_work(hashes.sha256d(h), int.from_bytes(
            h[72:76], "little"), params) for h in batch]
        _batch_counts_zero()
        sigs0 = dict(dw.program("sha256_headers").snapshot()["signatures"])
        calls = []
        real = hashes.sha256d
        hashes.sha256d = lambda b: calls.append(b) or real(b)
        try:
            t0 = time.perf_counter()
            got = check_headers_pow_batch(batch, params)
            wall = time.perf_counter() - t0
        finally:
            hashes.sha256d = real
        sigs = dw.program("sha256_headers").snapshot()["signatures"]
        new = {k: v - sigs0.get(k, 0) for k, v in sigs.items()
               if v != sigs0.get(k, 0)}
        t0 = time.perf_counter()
        [check_proof_of_work(hashes.sha256d(h), int.from_bytes(
            h[72:76], "little"), params) for h in batch]
        host_wall = time.perf_counter() - t0
        runs[label] = {"headers": len(batch), "equal": got == want,
                       "false": len(got) - sum(got), "shapes": new,
                       "wall_ms": wall * 1e3,
                       "per_header_host_ms": host_wall * 1e3,
                       "host_confirmations": sum(c != batch[0]
                                                 for c in calls),
                       **_batch_counts()}
    hs = [hashes.sha256d(h) for h in chain]
    _batch_counts_zero()
    root = certificate.mmr_root(hs)
    cert = {"leaves": len(hs), "equal": root == _hashlib_mmr(hs),
            **_batch_counts()}
    # MMR levels of 128 pairs or more: each peak of 2^k leaves has levels
    # of 2^(k-1), 2^(k-2), ... pairs
    levels = sum(1 for k in range(n.bit_length()) if n >> k & 1
                 for j in range(k) if 1 << j >= 128)
    checks = {
        "chain_equal": runs["chain"]["equal"] and runs["chain"]["false"] == 0,
        "one_launch_at_2048": all(r["sha256d_headers"] == 1
                                  and r["shapes"] == {"((2048, 20),)": 1}
                                  for r in runs.values()),
        "miss_false_and_confirmed": runs["miss_and_mined"]["equal"]
        and runs["miss_and_mined"]["false"] == 1
        and runs["miss_and_mined"]["host_confirmations"] == 1,
        "mined_headers": len(mined) > 0,
        "no_fallback": not any(r["fallbacks"]["sha256"]
                               for r in runs.values()),
        "mmr_equal": cert["equal"],
        "pairs_per_wide_level": cert["sha256d_pairs"] == levels == 6,
        "mmr_no_fallback": cert["fallbacks"]["merkle"] == 0,
    }
    return {"runs": runs, "certificate": cert, "checks": checks}


def merkle_gate_phase(sizes=(128, 512, 1024, 4096), reps: int = 7) -> dict:
    """The host compute_merkle_root beside the device leg end to end
    (ops/dispatch.merkle_root with the gate lowered to 1, the header's root
    given), median wall of ``reps`` calls after one warm-up, at each leaf
    count: where the reference's 512-leaf gate sits on this card."""
    import hashlib
    import statistics as st

    from bitcoincashplus_tpu_torch.consensus import merkle as CM
    from bitcoincashplus_tpu_torch.ops import dispatch

    out = {}
    for n in sizes:
        hs = [hashlib.sha256(f"gate:{n}:{i}".encode()).digest()
              for i in range(n)]
        root, _ = CM.compute_merkle_root(hs)
        row = {}
        for leg in ("host", "device"):
            def call(leg=leg):
                if leg == "host":
                    return CM.compute_merkle_root(hs)
                return dispatch.merkle_root(hs, expected=root)

            os.environ["BCP_TPU_MERKLE_MIN"] = "1" if leg == "device" \
                else str(1 << 40)
            try:
                if call() != (root, False):
                    raise AssertionError(f"merkle gate {n} {leg}: wrong root")
                ts = []
                for _ in range(reps):
                    t = time.perf_counter()
                    call()
                    ts.append(time.perf_counter() - t)
            finally:
                os.environ.pop("BCP_TPU_MERKLE_MIN", None)
            row[f"{leg}_ms"] = st.median(ts) * 1e3
        out[n] = row
    return out

# ---- the Schnorr MSM batch check (K9) --------------------------------------

MSM_BUCKETS = (64, 256, 1024, 4096, 8192, 16384)  # ecdsa_batch._MSM_BUCKETS
MSM_CURVE = (8, 31, 127, 2046, 8190)   # dispatch_batch sizes (Schnorr sigs)
MSM_CHAIN_SIGS = 8_000         # the Schnorr chain's dense signatures
MSM_ORACLE_LANES = 64          # chain lanes held against the oracle
# (squarings, multiplies) of csrc/secp256k1_complete.cuh's generic adds
# and dependent product levels of each formula at a team of 4 (one round
# a level): the mixed add 6, the full add 6, the double 3
SQR_MUL_CMADD, SQR_MUL_CFADD = (3, 8), (4, 12)
LEVELS_MADD, LEVELS_FADD, LEVELS_DOUBLE = 6, 6, 3


def msm_inputs(M: int, seed: int, zero_sum: bool) -> tuple:
    """An M-term MSM input (numpy (M, 32) uint8 xm, ym, km and (M,) inf8)
    with its sum, by known discrete logs (Q_j = c_j G, so the sum is
    (sum k_j c_j) G: one host point multiplication), and the crafted
    corpus on top of random terms. The kernel's walk splits each term in
    two (its |k1| half in stream o, its |k2| half in stream o + K/2, for
    the original terms o S .. (o + 1) S - 1, S = 2M / K: "original stream"
    o below, K/2 of them):
    - original stream 0 starts with Q, -Q, Q, Q under one scalar (P == -Q,
      then infinity + Q, then P == Q in every bucket those digits reach),
      a zero scalar and n - 1;
    - the last eighth of every original stream is flagged padding with
      garbage coordinates and nonzero scalars (adds nothing);
    - original stream K/4 is a copy of original stream 0 (the second merge
      level meets P == Q in every bucket) and, for K >= 8, original
      stream K/4 + 1 the negation of original stream 1 (P == -Q in every
      bucket);
    - zero_sum: one scalar of original stream 0 (and its copy) makes the
      sum the point at infinity.
    Returns (xm, ym, inf8, km, want) with want the affine sum or None."""
    import numpy as np

    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    rng = random.Random(seed)
    K = S.msm_streams(M)
    n_orig = max(1, K // 2)
    steps = M // n_orig
    pad = steps // 8
    logs = [0] * M
    scal = [rng.randrange(1, O.N) for _ in range(M)]
    flag = [False] * M
    pts = [None] * M
    c = rng.randrange(1, O.N)
    pt = O.point_mul(c, O.G)
    copies = {}
    if K >= 4:
        copies[K // 4] = (0, 1)
    if K >= 8:
        copies[K // 4 + 1] = (1, -1)
    for k in range(n_orig):
        if k in copies:
            continue
        for t in range(steps):
            j = k * steps + t
            if t >= steps - pad:
                flag[j] = True
                continue
            logs[j], pts[j] = c, pt
            c, pt = (c + 1) % O.N, O.point_add(pt, O.G)
    # the crafted head of stream 0
    k0 = scal[0]
    neg = (pts[0][0], O.P - pts[0][1])
    for t, (lg, p, sc) in enumerate(((logs[0], pts[0], k0),
                                     (O.N - logs[0], neg, k0),
                                     (logs[0], pts[0], k0),
                                     (logs[0], pts[0], k0))):
        logs[t], pts[t], scal[t] = lg, p, sc
    scal[4], scal[5] = 0, O.N - 1
    for k, (src, sign) in copies.items():
        for t in range(steps):
            j, i = k * steps + t, src * steps + t
            flag[j], scal[j] = flag[i], scal[i]
            if not flag[i]:
                logs[j] = logs[i] if sign > 0 else O.N - logs[i]
                pts[j] = pts[i] if sign > 0 else (pts[i][0], O.P - pts[i][1])
    if zero_sum:
        last = steps - pad - 1
        twins = [last] + [k * steps + last for k, (src, sign)
                          in copies.items() if src == 0]
        rest = sum(scal[j] * logs[j] for j in range(M)
                   if not flag[j] and j not in twins) % O.N
        w = len(twins) * logs[last] % O.N
        scal[last] = (-rest * pow(w, O.N - 2, O.N)) % O.N
        for j in twins:
            scal[j] = scal[last]
    total = sum(scal[j] * logs[j] for j in range(M) if not flag[j]) % O.N
    want = O.point_mul(total, O.G) if total else None
    xm = np.zeros((M, 32), np.uint8)
    ym = np.zeros((M, 32), np.uint8)
    km = np.zeros((M, 32), np.uint8)
    for j in range(M):
        x, y = pts[j] if not flag[j] else (rng.getrandbits(256),
                                           rng.getrandbits(256))
        xm[j] = np.frombuffer(x.to_bytes(32, "big"), np.uint8)
        ym[j] = np.frombuffer(y.to_bytes(32, "big"), np.uint8)
        km[j] = np.frombuffer(scal[j].to_bytes(32, "big"), np.uint8)
    return xm, ym, np.asarray(flag, np.uint8), km, want


def msm_tree_inputs(M: int, seed: int) -> tuple:
    """A sparse crafted M-term MSM (every other term flagged) for the
    kernel's reduction and window tree, as tests/test_torch_msm.py's
    msm_tree_corpus: scalars below 2^112 (each |k2| half 0); at the head
    of stream 0 one point four times under one scalar with windows 4 .. 20
    nonzero (the walk meets P == -Q and P == Q); window 22's bucket 1 U in
    stream 0 and in stream K/4, window 24's V and -V (the second merge
    level meets P == Q and P == -Q); window 31's buckets 1 and 3 Q = -8 R,
    window 30's buckets 5 and 7 R and -R (the bit sums meet P == Q and
    P == -Q); 16 W_30 == W_31 and 16 W_28 == -W_29 (the window tree meets
    P == Q and P == -Q). Returns what msm_inputs returns."""
    import numpy as np

    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    rng = random.Random(seed)
    K = S.msm_streams(M)
    steps = 2 * M // K
    logs, scal, flag = [0] * M, [0] * M, [True] * M
    slots = {0: iter(range(steps)),
             K // 4: iter(range(K // 4 * steps, K // 4 * steps + steps))}

    def put(c, k, stream=0):
        j = next(slots[stream])
        logs[j], scal[j], flag[j] = c % O.N, k, False

    c = rng.randrange(1, O.N)
    kw = sum(rng.randrange(1, 16) << (4 * (31 - w)) for w in range(4, 21))
    for sign in (1, -1, 1, 1):
        put(sign * c, kw)
    u, v = rng.randrange(1, O.N), rng.randrange(1, O.N)
    put(u, 1 << 4 * (31 - 22))
    put(u, 1 << 4 * (31 - 22), stream=K // 4)
    put(v, 1 << 4 * (31 - 24))
    put(-v, 1 << 4 * (31 - 24), stream=K // 4)
    r = rng.randrange(1, O.N)
    put(-8 * r, 1)
    put(-8 * r, 3)
    put(r, 5 << 4)
    put(-r, 7 << 4)
    w = rng.randrange(1, O.N)
    put(w, 1 << 12)
    put(-16 * w, 1 << 8)
    total = sum(scal[j] * logs[j] for j in range(M) if not flag[j]) % O.N
    xm = np.zeros((M, 32), np.uint8)
    ym = np.zeros((M, 32), np.uint8)
    km = np.zeros((M, 32), np.uint8)
    for j in range(M):
        x, y = (O.point_mul(logs[j], O.G) if not flag[j] else
                (rng.getrandbits(256), rng.getrandbits(256)))
        xm[j] = np.frombuffer(x.to_bytes(32, "big"), np.uint8)
        ym[j] = np.frombuffer(y.to_bytes(32, "big"), np.uint8)
        km[j] = np.frombuffer(scal[j].to_bytes(32, "big"), np.uint8)
    return (xm, ym, np.asarray(flag, np.uint8), km,
            O.point_mul(total, O.G) if total else None)


# the GLV split of a term (csrc/glv_split.cuh): the 64-bit products of its
# exact multi-word products (two roundings of 8x8, 8x4 and 4x8 words, then
# 4x4, 4x5, 4x4 and 4x4), one IMAD.WIDE each, and beta x (one fe_mul)
SPLIT_IMADS = 2 * (64 + 32 + 32) + 16 + 20 + 16 + 16 + IMAD_PER_FMUL


def _imads(madd: int, full: int, dbl: int) -> int:
    sq_m, mu_m = SQR_MUL_CMADD
    sq_f, mu_f = SQR_MUL_CFADD
    sq_d, mu_d = SQR_MUL_DOUBLE
    return (madd * (sq_m * IMAD_PER_FSQR + mu_m * IMAD_PER_FMUL)
            + full * (sq_f * IMAD_PER_FSQR + mu_f * IMAD_PER_FMUL)
            + dbl * (sq_d * IMAD_PER_FSQR + mu_d * IMAD_PER_FMUL))


def _bucket_hits(dig, live, K: int, windows: int):
    """(K, windows, 16) counts of live terms a (stream, window, digit),
    digit 0 zeroed (it adds nothing)."""
    import numpy as np

    steps = dig.shape[0] // K
    hits = np.zeros((K, windows, 16), np.int64)
    for k in range(K):
        d = dig[k * steps:(k + 1) * steps][live[k * steps:(k + 1) * steps]]
        for w in range(windows):
            hits[k, w] += np.bincount(d[:, w], minlength=16)
    hits[:, :, 0] = 0
    return hits


def _merge_adds(occ) -> tuple:
    """Full adds of the pairwise stream merge where both sides are
    occupied; the merged occupancy."""
    full, half = 0, occ.shape[0] // 2
    while half >= 1:
        full += int((occ[:half] & occ[half:2 * half]).sum())
        occ = occ[:half] | occ[half:2 * half]
        half //= 2
    return full, occ[0]


def msm_work(km, inf8) -> dict:
    """The point operations these inputs need on the kernel's schedule
    (csrc/msm.cu): mixed adds of the bucket walk over the GLV halves (a
    term into an occupied bucket; the first into an empty one is a copy),
    full adds of the merge levels, the bit-sum trees and the window tree
    where both sides are occupied, and their doublings where the doubled
    point is; their IMADs with the split's; and the longest chain of
    dependent product levels at a team of 4 (one round a level): the
    walk's busiest lane, log2 K merges, the reduction's 5 adds and 3
    doublings, the window tree's 5 adds and 124 doublings. Beside them,
    the Horner schedule on the same inputs (msm_work_horner)."""
    import numpy as np

    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    M = km.shape[0]
    K = S.msm_streams(M)
    m1, _n1, m2, _n2 = S.glv_decompose_batch_np(km)
    be = np.concatenate([m1, m2])[:, ::-1]  # (2M, 16) big-endian
    dig = np.stack([be >> 4, be & 15], axis=2).reshape(2 * M, 32)
    live = np.concatenate([inf8 == 0, inf8 == 0])
    hits = _bucket_hits(dig, live, K, 32)
    madd = int(np.maximum(hits - 1, 0).sum())
    full, occ = _merge_adds(hits > 0)
    dbl = 0
    win = []
    for w in range(32):
        bits = []
        for i in range(4):
            t = [bool(occ[w, b]) for b in range(1, 16) if (b >> i) & 1]
            while len(t) > 1:
                full += sum(a and b for a, b in zip(t[0::2], t[1::2]))
                t = [a or b for a, b in zip(t[0::2], t[1::2])]
            bits.append(t[0])
        c = []
        for hi, lo in ((3, 2), (1, 0)):
            dbl += int(bits[hi])
            full += int(bits[hi] and bits[lo])
            c.append(bits[hi] or bits[lo])
        dbl += 2 * int(c[0])
        full += int(c[0] and c[1])
        win.append(c[0] or c[1])
    for level in range(5):
        a, b = win[0::2], win[1::2]
        dbl += sum(4 << level for x in a if x)
        full += sum(x and y for x, y in zip(a, b))
        win = [x or y for x, y in zip(a, b)]
    levels = (int(np.maximum(hits - 1, 0).sum(axis=2).max()) * LEVELS_MADD
              + (K.bit_length() - 1) * LEVELS_FADD
              + 5 * LEVELS_FADD + 3 * LEVELS_DOUBLE
              + 5 * LEVELS_FADD + 124 * LEVELS_DOUBLE)
    return {"madd": madd, "full": full, "double": dbl,
            "imads": _imads(madd, full, dbl) + SPLIT_IMADS * int(
                (inf8 == 0).sum()),
            "chain_levels": levels, "horner": msm_work_horner(km, inf8)}


def msm_work_horner(km, inf8) -> dict:
    """The same count on the Horner schedule (kept for comparison): K =
    min(128, M / 32) streams of 64 windows over the whole scalars, the
    suffix-sum reduction and the 64-window Horner pass."""
    import numpy as np

    M = km.shape[0]
    K = max(1, min(128, M // 32))
    dig = np.stack([km >> 4, km & 15], axis=2).reshape(M, 64)
    hits = _bucket_hits(dig, inf8 == 0, K, 64)
    madd = int(np.maximum(hits - 1, 0).sum())
    full, occ = _merge_adds(hits > 0)
    win = []
    for w in range(64):
        run = tot = False
        for b in range(15, 0, -1):
            full += int(run and occ[w, b])
            run = run or bool(occ[w, b])
            full += int(tot and run)
            tot = tot or run
        win.append(tot)
    dbl = 0
    acc = False
    for w in range(64):
        dbl += 4 * acc
        full += int(acc and win[w])
        acc = acc or win[w]
    levels = (int(np.maximum(hits - 1, 0).sum(axis=2).max()) * LEVELS_MADD
              + (K.bit_length() - 1) * LEVELS_FADD + 30 * LEVELS_FADD
              + 256 * LEVELS_DOUBLE + 64 * LEVELS_FADD)
    return {"madd": madd, "full": full, "double": dbl,
            "imads": _imads(madd, full, dbl), "chain_levels": levels}


def msm_case(M: int, seed: int, clock_hz: float, fe_cycles: float,
             reps: int = 20) -> dict:
    """The MSM kernel at one bucket, against its plain version on the card
    and the host's sum: for msm_inputs with a nonzero sum and with a zero
    one, and for msm_tree_inputs, the verdict entry
    (schnorr_msm_is_infinity) and the partial entry (msm_partial_point:
    its canonical Jacobian triple equal to the plain version's, its affine
    point to the host's); on msm_tree_inputs the plain version's complete
    adds must meet P == Q and P == -Q in every stage. Times (device time
    behind a spin kernel): the C entry msm_run, and each launch kind alone
    (msm_split, msm_buckets, msm_merge (all its levels), msm_reduce,
    msm_combine); the plain version's wall; the IMAD bound, the fewer of
    msm_work's two schedules (this kernel's, and the Horner schedule's on
    the whole scalars), each beside it; the chain floor (dependent levels
    x one dependent fe_mul's cycles) of both."""
    import ctypes

    import torch

    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    dev = torch.device("cuda")
    K = S.msm_streams(M)
    cases, err = [], 0
    for kind in ("nonzero", "zero", "tree"):
        xm, ym, inf8, km, want = (msm_tree_inputs(M, seed) if kind == "tree"
                                  else msm_inputs(M, seed, kind == "zero"))
        ts = [torch.from_numpy(a).to(dev) for a in (xm, ym, inf8, km)]
        verdict = int(S.schnorr_msm_is_infinity(*ts)[0])
        (X, Y, Z), inf = S.msm_partial_point(*ts)
        tally = {}
        plain_ms, pt = time_once(
            lambda: S.msm_accumulate_plain(*ts, tally=tally), dev)
        (pX, pY, pZ), pinf = S._point_result(pt)
        if inf:
            affine = None
        else:
            zi = pow(Z, O.P - 2, O.P)
            affine = (X * zi * zi % O.P, Y * zi * zi * zi % O.P)
        checks = {
            "verdict_equal_plain": verdict == int(pinf),
            "verdict_equal_host": verdict == int(want is None)
            == int(kind == "zero"),
            "partial_equal_plain": ((X, Y, Z), inf) == ((pX, pY, pZ), pinf),
            "affine_equal_host": affine == want,
        }
        if kind == "tree":
            checks["every_special_case"] = all(
                tally[st]["same"] and tally[st]["opposite"]
                for st in ("walk", "merge", "reduce", "combine"))
        if not all(checks.values()):
            raise AssertionError(f"msm M={M} {kind}: {checks}, {tally}")
        err = max(err, max(abs(a - b) for a, b in zip((X, Y, Z),
                                                       (pX, pY, pZ))))
        cases.append({"kind": kind, "plain_ms": plain_ms, "tally": tally,
                      "work": msm_work(km, inf8)})
    # times on the nonzero-sum input
    xm, ym, inf8, km, _want = msm_inputs(M, seed, False)
    ts = [torch.from_numpy(a).to(dev) for a in (xm, ym, inf8, km)]
    ptrs = [t.data_ptr() for t in ts]
    sc = [torch.empty(n, dtype=torch.int32, device=dev)
          for n in S.msm_scratch_words(M).values()]
    terms, bk, ws = (t.data_ptr() for t in sc)
    out = torch.empty(S.MSM_WORDS, dtype=torch.int32, device=dev)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    ms = time_device(entry_call("msm_run", [P_] * 8 + [I_] * 2 + [P_], *ptrs,
                                terms, bk, ws, out.data_ptr(), M, K),
                     clock_hz, reps)
    merge = [entry_call("msm_merge", [P_] + [I_] * 2 + [P_], bk, K, half)
             for half in (K >> i for i in range(1, K.bit_length()))]
    calls = {
        "msm_split": entry_call("msm_split", [P_] * 5 + [I_, P_], *ptrs,
                                terms, M),
        "msm_buckets": entry_call("msm_buckets", [P_] * 2 + [I_] * 2 + [P_],
                                  terms, bk, M, K),
        "msm_merge": (lambda: [f() for f in merge]) if merge else None,
        "msm_reduce": entry_call("msm_reduce", [P_, I_, P_, P_], bk, K, ws),
        "msm_combine": entry_call("msm_combine", [P_] * 3, ws,
                                  out.data_ptr()),
    }
    stages = {k: time_device(f, clock_hz, reps) if f else 0.0
              for k, f in calls.items()}
    work = cases[0]["work"]
    ops_bound = work["imads"] / (SMS * IMAD_PER_SM_CLK * clock_hz) * 1e3
    bytes_bound = (M * (3 * 32 + 1) + 4 * S.MSM_WORDS) / HBM_BYTES_S * 1e3
    old = work["horner"]
    old_ops = old["imads"] / (SMS * IMAD_PER_SM_CLK * clock_hz) * 1e3
    # the function's least work: the fewer IMADs of the two schedules
    least = min(ops_bound, old_ops)
    b = {"bound_ms": max(least, bytes_bound),
         "bound_by": "operations" if least >= bytes_bound else "bytes",
         "bound_ms_split": max(ops_bound, bytes_bound),
         "bound_ms_horner": max(old_ops, bytes_bound)}
    return {"M": M, "K": K, "ms": ms, "stages": stages,
            "plain_ms": cases[0]["plain_ms"], "max_abs_err": err,
            "work": work, **b,
            "chain_floor_ms": work["chain_levels"] * fe_cycles / clock_hz
            * 1e3,
            "chain_floor_ms_horner": old["chain_levels"] * fe_cycles
            / clock_hz * 1e3,
            "tree_tally": cases[2]["tally"], "cases": 2 * len(cases)}


def msm_team_sweep(clock_hz: float, reps: int = 20) -> list:
    """csrc/msm.cu built twice, with its walk and merges on teams of 2
    (-DMSM_WALK_TEAM=2) and of 4 (-DMSM_WALK_TEAM=4) at every size, both
    nvcc processes started together; msm_run of each timed at every bucket
    on msm_inputs' nonzero-sum input (device time behind the spin kernel;
    the order 4, 2, 2, 4), each affine sum held against the host's."""
    import ctypes

    import torch

    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O
    from bitcoincashplus_tpu_torch.ops import cuda_build
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    src = os.path.join(cuda_build.CSRC_DIR, "msm.cu")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for team in (2, 4):
        out = os.path.join(cuda_build.BUILD_DIR, f"msm_team{team}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
               f"-DMSM_WALK_TEAM={team}", "-o", out, src]
        procs[team] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for team, (out, proc) in procs.items():
        text, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"msm.cu with teams of {team}: {text[-2000:]}")
        libs[team] = ctypes.CDLL(out)
    dev = torch.device("cuda")
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    rows = []
    for i, M in enumerate(MSM_BUCKETS):
        K = S.msm_streams(M)
        xm, ym, inf8, km, want = msm_inputs(M, 700 + i, False)
        keep = [torch.from_numpy(a).to(dev) for a in (xm, ym, inf8, km)]
        ptrs = [t.data_ptr() for t in keep]
        calls = {}
        for team, lib in libs.items():
            sc = [torch.empty(n, dtype=torch.int32, device=dev)
                  for n in S.msm_scratch_words(M).values()]
            out = torch.empty(S.MSM_WORDS, dtype=torch.int32, device=dev)
            keep += sc + [out]
            fn = lib.msm_run
            fn.argtypes = [P_] * 8 + [I_] * 2 + [P_]
            fn.restype = ctypes.c_int
            args = [*ptrs, *(t.data_ptr() for t in sc), out.data_ptr(), M, K]

            def call(fn=fn, args=args):
                cuda_build.check_launch("msm_run", fn(
                    *args, torch.cuda.current_stream(dev).cuda_stream))
            calls[team] = (call, out)
        times = {2: [], 4: []}
        for team in (4, 2, 2, 4):
            times[team].append(time_device(calls[team][0], clock_hz, reps))
        for team, (_call, out) in calls.items():
            (X, Y, Z), inf = S._words_result(out)
            zi = pow(Z, O.P - 2, O.P)
            got = None if inf else (X * zi * zi % O.P, Y * zi ** 3 % O.P)
            if got != want:
                raise AssertionError(f"msm M={M}, teams of {team}: the sum "
                                     f"differs from the host's")
        rows.append({"M": M, "K": K, "lanes": 32 * K,
                     "team4_ms": times[4], "team2_ms": times[2]})
        log(f"msm_run M={M} (K={K}, {32 * K} lanes): teams of 4 "
            f"{times[4][0]:.4f} / {times[4][1]:.4f} ms, teams of 2 "
            f"{times[2][0]:.4f} / {times[2][1]:.4f} ms; both sums equal "
            f"to the host's")
    return rows


def schnorr_records(signers: list, n: int, seed: int, forged=()) -> list:
    """n Schnorr SigCheckRecords over seeded digests, round robin over the
    signers (workload/sigchain.SchnorrSigner); the lanes in ``forged``
    carry the digest + 1 (a signature that must fail)."""
    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O
    from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord

    rng = random.Random(seed)
    out = []
    for i in range(n):
        sg = signers[i % len(signers)]
        e = rng.getrandbits(256) % O.N
        r, s = sg.sign(e)
        out.append(SigCheckRecord(sg.pub, r, s,
                                  (e + 1) % O.N if i in forged else e,
                                  algo="schnorr"))
    return out


def schnorr_oracle(recs) -> tuple:
    """(verdicts, wall s) of the per-lane Python-int oracle."""
    import numpy as np

    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O

    t0 = time.perf_counter()
    got = np.array([O.schnorr_verify(r.pubkey, r.r, r.s, r.msg_hash)
                    for r in recs])
    return got, time.perf_counter() - t0


MSM_STAT_KEYS = ("schnorr_sigs", "schnorr_cpu_sigs", "msm_dispatches",
                 "msm_batches_accepted", "msm_batches_rejected",
                 "msm_bisects", "msm_bisect_depth_max", "msm_fallback_sigs",
                 "msm_canary_failures", "msm_host_s", "msm_device_s",
                 "msm_canary_s", "cpu_fallback_sigs", "fault_fallback_sigs",
                 "kat_failures", "glv_dev_dispatches", "glv_fallbacks",
                 "glv_dev_fallbacks")


def msm_dispatch_phase(signers: list, seed: int = 800,
                       forged: tuple = (2046, 1000)) -> dict:
    """dispatch_batch(recs, backend="device", kernel="msm") at each
    MSM_CURVE size (counts zeroed just before each, read just after):
    sigs/s, the launches, the split of the MSM time (host, kernel call,
    canaries); verdicts equal to the oracle's at 8 and 31 (its sigs/s
    beside), all True above (valid by construction); then one forged
    signature at lane 1000 of 2046 (``forged``: False at its lane only,
    the bisect counters); then
    the drills at ecdsa_msm (fail-always: the batch served by the oracle,
    no launch; poison-output: the canary trips, then the oracle), each
    with the oracle's verdicts; then one dispatch_packed slice of
    PACKED_LANES ECDSA signatures under -ecdsakernel=msm: the w4 byte
    entry launched, no GLV entry, the oracle's verdicts, no fallback."""
    import numpy as np

    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.util import faults

    rows = {}

    def run(recs):
        _zero_counts()
        t0 = time.perf_counter()
        got = E.dispatch_batch(recs, backend="device", kernel="msm").result()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        st = counts["stats"]
        return got, wall, counts, {k: st[k] for k in MSM_STAT_KEYS}

    def precheck_s(recs):
        # the host prechecks (r's lift) of a batch, timed alone: the
        # dispatch runs them outside the timed checks of STATS.msm_host_s
        t0 = time.perf_counter()
        for r in recs:
            E._schnorr_precheck(r)
        return time.perf_counter() - t0

    for i, n in enumerate(MSM_CURVE):
        recs = schnorr_records(signers, n, seed + i)
        got, wall, counts, st = run(recs)
        row = {"n": n, "wall_s": wall, "sigs_per_s": n / wall,
               "precheck_s": precheck_s(recs),
               "launches": counts["launches"],
               "launch_shapes": counts["launch_shapes"], "stats": st}
        checks = {"no_fallback": st["cpu_fallback_sigs"] == 0
                  and st["fault_fallback_sigs"] == 0
                  and st["msm_fallback_sigs"] == 0,
                  "msm_launched": counts["launches"]["msm"] >= 2}
        if n <= 31:
            want, o_wall = schnorr_oracle(recs)
            row["oracle_sigs_per_s"] = n / o_wall
            checks["equal_oracle"] = bool(np.array_equal(got, want))
        else:
            checks["all_true"] = bool(got.all())
        row["checks"] = checks
        rows[f"n={n}"] = row
    n, pos = forged
    recs = schnorr_records(signers, n, seed + 50, forged={pos})
    got, wall, counts, st = run(recs)
    rows["forged"] = {
        "n": n, "position": pos, "wall_s": wall,
        "launches": counts["launches"], "stats": st,
        "checks": {"false_at_its_lane_only": (not got[pos])
                   and int(got.sum()) == n - 1,
                   "bisected": st["msm_bisects"] > 0
                   and st["msm_bisect_depth_max"] > 0,
                   "no_fallback": st["msm_fallback_sigs"] == 0}}
    recs = schnorr_records(signers, 9, seed + 60, forged={4})
    want, _ = schnorr_oracle(recs)
    for mode in ("fail-always", "poison-output"):
        os.environ.update(BCP_FAULT_MODE=mode, BCP_FAULT_OPS=E.MSM_SITE)
        faults.INJECTOR.reload()
        try:
            got, wall, counts, st = run(recs)
        finally:
            for k in ("BCP_FAULT_MODE", "BCP_FAULT_OPS"):
                os.environ.pop(k, None)
            faults.INJECTOR.reload()
        checks = {"equal_oracle": bool(np.array_equal(got, want)),
                  "oracle_served": st["msm_fallback_sigs"] == len(recs)}
        if mode == "fail-always":
            checks["no_launch"] = counts["launches"]["msm"] == 0
        else:
            checks["canary_tripped"] = st["msm_canary_failures"] > 0
        rows[f"drill {mode}"] = {"launches": counts["launches"],
                                 "stats": st, "checks": checks}
    # a packed ECDSA slice under -ecdsakernel=msm: the reference's gate
    # sends it to the w4 byte entry, and no GLV leg runs
    recs = signed_records(PACKED_LANES, seed + 70)
    blobs = E.records_to_blobs(recs)
    before = E._KERNEL
    E.set_kernel("msm")
    try:
        _zero_counts()
        t0 = time.perf_counter()
        got = E.dispatch_packed(*blobs, backend="device").result()
        wall = time.perf_counter() - t0
        counts = _read_counts()
    finally:
        E._KERNEL = before
    st = counts["stats"]
    rows["packed ecdsa"] = {
        "n": len(recs), "wall_s": wall, "launches": counts["launches"],
        "launch_shapes": counts["launch_shapes"],
        "stats": {k: st[k] for k in MSM_STAT_KEYS},
        "checks": {"w4_bytes_launched":
                   counts["launches"]["w4_verify_bytes"] >= 1,
                   "no_glv_launch": all(counts["launches"][k] == 0
                                        for k in GLV_ENTRIES),
                   "equal_oracle": bool(np.array_equal(got,
                                                       host_oracle(recs))),
                   "no_fallback": st["cpu_fallback_sigs"] == 0
                   and st["fault_fallback_sigs"] == 0}}
    _zero_counts()
    return rows


def msm_chain_phase(workdir: str, signers: list,
                    sigs: int = MSM_CHAIN_SIGS, runs: int = 3,
                    seed: int = 900) -> dict:
    """The Schnorr path: a regtest chain of ``sigs`` Schnorr-signed dense
    inputs (workload/sigchain.generate(schnorr=True): 250 inputs a
    transaction, 8 a block; the runway and fan-out ECDSA) validated under
    -ecdsakernel=msm ``runs`` times at PIPELINE_DEPTH through the node's
    2046-lane LanePacker (counts zeroed just before each run, read just
    after): its coin digest and best block equal to those of the same
    blocks connected without script checks, the tampered tip (a byte of
    one Schnorr s altered) rejected, MSM launches and the GLV launches of
    the ECDSA lanes counted, no fallback of any kind. Then
    MSM_ORACLE_LANES of the chain's Schnorr lanes, drawn at random, held
    against the oracle (valid: the chain's verdict), and the host
    prechecks of all its Schnorr lanes timed alone."""
    from bitcoincashplus_tpu_torch.consensus.block import CBlock
    from bitcoincashplus_tpu_torch.consensus.params import regtest_params
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.store.blockstore import MemoryBlockStore
    from bitcoincashplus_tpu_torch.validation.chain import BlockStatus
    from bitcoincashplus_tpu_torch.validation.chainstate import (
        ChainstateManager)
    from bitcoincashplus_tpu_torch.validation.coins import MemoryCoinsView
    from bitcoincashplus_tpu_torch.workload import sigchain

    t0 = time.monotonic()
    gen = sigchain.generate(workdir, sigs, tip_inputs=16, schnorr=True)
    gen_s = time.monotonic() - t0
    log(f"schnorr chain: {gen['blocks']} blocks, {gen['sigs']} Schnorr "
        f"sigs, {gen['bytes']} bytes, generated in {gen_s:.1f} s")
    t0 = time.monotonic()
    ref = ChainstateManager(regtest_params(), MemoryCoinsView(),
                            MemoryBlockStore(), script_verifier=None)
    for block in sigchain.read_blocks(workdir):
        ref.process_new_block(block)
    ref_digest = sigchain.coin_digest(ref)
    noscript_s = time.monotonic() - t0
    bad = CBlock.from_bytes(gen["tampered_tip"])
    out = []
    for i in range(runs):
        _zero_counts()
        t0 = time.monotonic()
        cs, dev = sigchain.validate_chain(workdir, "device", kernel="msm",
                                          depth=PIPELINE_DEPTH)
        wall = time.monotonic() - t0
        cs.process_new_block(bad)
        rejected = bool(cs.block_index[bad.get_hash()].status
                        & BlockStatus.FAILED_VALID) \
            and cs.tip().hash == dev_tip(dev)
        counts = _read_counts()
        st = counts["stats"]
        launches = counts["launches"]
        checks = {
            "digest_equal_noscript": dev["digest"] == ref_digest,
            "best_equal_noscript": dev["best"] == ref.tip().hash.hex(),
            "tampered_rejected": rejected,
            "msm_launched": launches["msm"] > 0,
            "glv_for_ecdsa": launches["glv_dev_verify"] > 0,
            "no_cpu_fallback": st["cpu_fallback_sigs"] == 0,
            "no_fault_fallback": st["fault_fallback_sigs"] == 0,
            "no_msm_fallback": st["msm_fallback_sigs"] == 0,
            "no_kat_failures": st["kat_failures"] == 0,
            "breaker_healthy": counts["healthy"],
        }
        out.append({"wall_s": wall, "sigs_per_s": gen["sigs"] / wall,
                    "launches": launches,
                    "launch_shapes": counts["launch_shapes"],
                    "stats": {k: st[k] for k in MSM_STAT_KEYS},
                    "checks": checks})
    recs = [r for r in sigchain.chain_sig_records(workdir, 10 ** 9)
            if r.algo == "schnorr"]
    rng = random.Random(seed)
    sample = rng.sample(recs, MSM_ORACLE_LANES)
    want, o_wall = schnorr_oracle(sample)
    t0 = time.perf_counter()
    for r in recs:
        E._schnorr_precheck(r)
    precheck_s = time.perf_counter() - t0
    return {"gen": {k: v for k, v in gen.items() if "tip" not in k},
            "gen_s": gen_s, "noscript_s": noscript_s,
            "schnorr_lanes": len(recs), "precheck_s": precheck_s,
            "runs": out,
            "oracle": {"lanes": len(sample), "all_true": bool(want.all()),
                       "sigs_per_s": len(sample) / o_wall}}


# ---- the bit ladder (K8) ------------------------------------------------------

# every plane bucket of the record dispatch the node's paths reach: 32 and
# 128 small batches, 2048 the record route's tail chunks, 8192 its slices
LADDER_SHAPES = (32, 128, 512, 2048, 8192, 16384)
# (squarings, products) of the ladder's formulas (csrc/ladder_verify.cu):
# the doubling, a complete mixed add between finite points, the final check
SQR_MUL_LADDER_DOUBLE, SQR_MUL_LADDER_ADD, SQR_MUL_LADDER_FINAL = \
    (5, 2), (3, 8), (1, 2)


def ladder_records(n: int, seed: int) -> list:
    """signed_records with four crafted lanes at 20 .. 23 (the corpus of
    tests/test_torch_ladder.py): u1 = 0; Q = G; Q = -G; and Q = -G with
    e = r, so u1 == u2 and the first add meets the accumulator's negative
    (the sum is infinity: invalid). signed_records' own degenerate lanes
    (Q = G, e = r: the ladder's adds meet P == Q) stay."""
    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O
    from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord

    out = signed_records(n, seed)
    rng = random.Random(seed + 2)

    def signed(d, e):
        r, s_ = O.ecdsa_sign(d, e)
        return SigCheckRecord(O.point_mul(d, O.G), r, s_, e)

    r = rng.randrange(1, O.N)
    crafted = [signed(rng.randrange(1, O.N), 0), signed(1, rng.randrange(O.N)),
               signed(O.N - 1, rng.randrange(O.N)),
               SigCheckRecord(O.point_mul(O.N - 1, O.G), r,
                              rng.randrange(1, O.N), r)]
    out[20:24] = crafted
    return out


def _digits_of_planes(bits):
    """(256, B) bool bit planes, MSB first -> (64, B) 4-bit windows."""
    import numpy as np

    w = bits.reshape(64, 4, -1).astype(np.int64)
    return (w[:, 0] << 3) | (w[:, 1] << 2) | (w[:, 2] << 1) | w[:, 3]


def ladder_imad_count(u1_bits, u2_bits, q_inf) -> dict:
    """The 32-bit IMADs the windowed ladder's function needs on this data,
    per finite lane: the Q table (a doubling and 13 complete mixed adds,
    Q being affine), 4 doublings a window after the first nonzero digit, a
    complete mixed add a nonzero digit of u1 (G's table is affine) and a
    complete full add a nonzero digit of u2 (the Q table is Jacobian), but
    not the first add (into infinity: a copy; the rare P == Q and P == -Q
    cases counted as generic adds), and the final check. The kernel takes
    the full add for G's digits too, to save registers: that is its cost,
    not the function's. And the longest lane's chain of dependent product
    levels at a team of 4 (the table's 3 + 13 x 6, 3 a doubling, 6 an add,
    2 for the check). (256, B) bit planes. Beside them, the bit ladder on
    the same data (ladder_imad_count_bits)."""
    import numpy as np

    dbl, madd, fadd, final = (
        s * IMAD_PER_FSQR + m * IMAD_PER_FMUL
        for s, m in (SQR_MUL_LADDER_DOUBLE, SQR_MUL_CMADD, SQR_MUL_CFADD,
                     SQR_MUL_LADDER_FINAL))
    live = ~np.asarray(q_inf, bool)
    d1 = _digits_of_planes(np.asarray(u1_bits) != 0)
    d2 = _digits_of_planes(np.asarray(u2_bits) != 0)
    nz = (d1 != 0) | (d2 != 0)
    started = nz.any(0)
    first = np.where(started, nz.argmax(0), 64)
    doublings = 4 * np.maximum(0, 63 - first)
    # the first add is u1's where its digit in the first window is nonzero
    g_first = started & (d1[np.minimum(first, 63), np.arange(d1.shape[1])]
                         != 0)
    madds = (d1 != 0).sum(0) - g_first
    fadds = (d2 != 0).sum(0) - (started & ~g_first)
    imads = (dbl + 13 * madd) + dbl * doublings + madd * madds \
        + fadd * fadds + final * started
    levels = 3 + 13 * 6 + 3 * doublings + 6 * (madds + fadds) + 2 * started
    return {"imads": int(imads[live].sum()),
            "chain_levels": int(levels[live].max()) if live.any() else 0,
            "bits": ladder_imad_count_bits(u1_bits, u2_bits, q_inf)}


def ladder_imad_count_bits(u1_bits, u2_bits, q_inf) -> dict:
    """The same count on the bit ladder (kept for comparison): a
    doubling a step after the first set bit, a complete mixed add a set
    bit but the first, and the final check; the longest lane's chain."""
    import numpy as np

    dbl, madd, final = (s * IMAD_PER_FSQR + m * IMAD_PER_FMUL
                        for s, m in (SQR_MUL_LADDER_DOUBLE, SQR_MUL_LADDER_ADD,
                                     SQR_MUL_LADDER_FINAL))
    b1 = np.asarray(u1_bits) != 0
    b2 = np.asarray(u2_bits) != 0
    live = ~np.asarray(q_inf, bool)
    b2 = b2 & live[None, :]
    any_set = b1 | b2
    started = any_set.any(0)
    first = np.where(started, any_set.argmax(0), 256)
    doublings = np.maximum(0, 255 - first)
    adds = b1.sum(0) + b2.sum(0) - started
    imads = dbl * doublings + madd * adds + final * started
    levels = 3 * doublings + 6 * adds + 2 * started
    return {"imads": int(imads[live].sum()),
            "chain_levels": int(levels[live].max()) if live.any() else 0}


def ladder_case(B: int, seed: int, clock_hz: float, fe_cycles: float = 0.0,
                device: str = "cuda") -> dict:
    """The windowed ladder (entry ladder_verify) at one plane bucket on
    pack_records' planes of ladder_records, with craft_lanes' q_inf and
    wrap lanes and padding: the wrapper's verdicts equal to the plain
    version's lane for lane on the card and to the oracle (q_inf, wrap-off
    and padding lanes False); the entry timed by CUDA events; the plain
    version's wall; the bound and the chain floor, beside the bit
    ladder's. (On a CPU device the
    wrapper itself takes the plain version, and nothing is timed: a
    rehearsal of the checks.)"""
    import ctypes

    import numpy as np
    import torch

    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    n = B - 3  # three padding lanes (q_inf by the packer)
    recs = ladder_records(n, seed)
    order = ("u1", "u2", "qx", "qy", "q_inf", "r0", "rn", "wrap")
    arrays = dict(zip(order, [x.copy() for x in E.pack_records(recs, B)]))
    kinds = craft_lanes(arrays, n, be=False)
    dev = torch.device(device)
    tens = []
    for k in order:
        x = np.ascontiguousarray(arrays[k])
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        tens.append(torch.from_numpy(x).to(dev))
    plain_ms, plain = time_once(lambda: S.ladder_planes_plain(*tens), dev)
    ok = S.ecdsa_verify_batch_jit(*tens).cpu().numpy()
    plain = plain.cpu().numpy()
    oracle = host_oracle(recs)
    want = np.zeros(B, bool)
    want[:n] = oracle
    want[kinds["q_inf"] + kinds["wrap_off"]] = False
    err = int(np.abs(ok.astype(int) - plain.astype(int)).max())
    if err:
        raise AssertionError(f"ladder_verify B={B}: differs from the plain "
                             f"version at {np.nonzero(ok != plain)[0][:10]}")
    if not np.array_equal(ok, want):
        raise AssertionError(f"ladder_verify B={B}: differs from the oracle "
                             f"at {np.nonzero(ok != want)[0][:10]}")
    if not (ok[20:23].all() and not ok[23] and oracle[:n].any()
            and (~oracle[:n]).any()):
        raise AssertionError(f"ladder_verify B={B}: crafted lanes wrong")
    ms = plain_ms
    if dev.type == "cuda":
        u8 = [t.to(torch.uint8) for t in (tens[4], tens[7])]
        out = torch.empty(B, dtype=torch.uint8, device=dev)
        args = [tens[0], tens[1], tens[2], tens[3], u8[0], tens[5], tens[6],
                u8[1], out]
        ms = time_cuda(entry_call("ladder_verify", [ctypes.c_void_p] * 9
                                  + [ctypes.c_int, ctypes.c_void_p],
                                  *[t.data_ptr() for t in args], B),
                       10 if B <= 8192 else 5)
        if not np.array_equal(out.cpu().numpy().astype(bool), ok):
            raise AssertionError(f"ladder_verify B={B}: the timed launches "
                                 f"differ from the wrapper's")
    work = ladder_imad_count(arrays["u1"], arrays["u2"], arrays["q_inf"])
    in_bytes = B * (2 * 256 * 4 + 4 * 20 * 4 + 2)
    bytes_ms = (in_bytes + B) / HBM_BYTES_S * 1e3

    def bound_of(imads):
        return max(imads / (SMS * IMAD_PER_SM_CLK * clock_hz) * 1e3, bytes_ms)

    ops_ms = work["imads"] / (SMS * IMAD_PER_SM_CLK * clock_hz) * 1e3
    return {"B": B, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_of(work["imads"]),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ms_bits": bound_of(work["bits"]["imads"]),
            "imads": work["imads"], "imads_bits": work["bits"]["imads"],
            "chain_levels": work["chain_levels"],
            "chain_levels_bits": work["bits"]["chain_levels"],
            "chain_floor_ms": work["chain_levels"] * fe_cycles / clock_hz
            * 1e3,
            "chain_floor_ms_bits": work["bits"]["chain_levels"] * fe_cycles
            / clock_hz * 1e3,
            "bytes_in": in_bytes, "max_abs_err": err,
            "sigs_per_s": B / (ms / 1e3), "valid": int(ok.sum())}


# the node's -reindex runs of phase 5d: (name, flags, environment)
NODE_RUNS = (("tpu0", {"tpu": "0"}, {}),
             ("glv", {}, {}),
             ("ladder", {"ecdsakernel": "w4"}, {"BCP_SECP_PALLAS": "0"}))


def node_phase(chain_dir: str, sigs: int) -> dict:
    """The node's -reindex (workload/sigchain.reindex: node/node.Node in
    process with -regtest -reindex) of the chain in ``chain_dir``, once a
    run of NODE_RUNS, each on a fresh copy of the datadir, counts zeroed
    just before and read just after: -tpu=0 (the CPU engine; its digest
    is the one of record), the default (GLV), and BCP_SECP_PALLAS=0
    -ecdsakernel=w4 (the packed slices take the record route to the bit
    ladder). Each with its wall, sigs/s, engine, digest, launches per
    kernel and fallback counters (the ecdsa STATS and every breaker's
    fallback_calls)."""
    from bitcoincashplus_tpu_torch.ops import dispatch
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.workload import sigchain

    rows = {}
    for name, flags, env in NODE_RUNS:
        d = os.path.join(os.path.dirname(chain_dir), f"node_{name}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(chain_dir, d)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            _zero_counts()
            run = sigchain.reindex(d, **flags)
            counts = _read_counts()
            breakers = dispatch.snapshot()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            E.set_kernel("glv")
            shutil.rmtree(d, ignore_errors=True)
        stats = counts["stats"]
        rows[name] = {
            "flags": " ".join([f"{k}={v}" for k, v in env.items()]
                              + [f"-{k}={v}" for k, v in flags.items()])
            or "the defaults",
            **{k: run[k] for k in ("height", "best", "muhash", "wall_s",
                                   "engine")},
            "sigs_per_s": sigs / run["wall_s"],
            "import_stats": {k: v for k, v in (run["import_stats"]
                                               or {}).items()
                             if isinstance(v, (int, float))},
            "launches": counts["launches"],
            "launch_shapes": counts["launch_shapes"],
            "fallbacks": {
                "cpu_fallback_sigs": stats["cpu_fallback_sigs"],
                "fault_fallback_sigs": stats["fault_fallback_sigs"],
                "breaker_fallback_calls": sum(
                    b["fallback_calls"] for b in breakers.values())},
            "stats": {k: stats[k] for k in STAT_KEYS}}
    record = rows["tpu0"]
    launches = {k: rows[k]["launches"] for k in rows}
    ladder = launches["ladder"]
    checks = {
        f"{k}_{f}_equal": rows[k][f] == record[f]
        for k in ("glv", "ladder") for f in ("height", "best", "muhash")}
    checks.update({
        "tpu0_no_launch": sum(launches["tpu0"].values()) == 0,
        "glv_launched": launches["glv"]["glv_dev_verify"] > 0,
        "glv_no_ladder": launches["glv"]["ladder_verify"] == 0,
        "ladder_launched": ladder["ladder_verify"] > 0,
        "ladder_no_w4_or_glv": all(ladder[k] == 0 for k in
                                   W4_ENTRIES + GLV_ENTRIES),
        "no_fallback": all(v == 0 for k in ("glv", "ladder")
                           for v in rows[k]["fallbacks"].values()),
        "same_engine": len({r["engine"] for r in rows.values()}) == 1,
    })
    return {"runs": rows, "checks": checks}


# ---- the live-traffic path: signature serving ---------------------------------

# the reference's serving levels (bench.py's _bench_serving_levels): name,
# transactions (2 fresh signatures each), submitters, open loop
SERVING_LEVELS = (("light", 100, 1, False), ("concurrent", 500, 8, False),
                  ("saturation", 1000, 1, True))
# the node's -sigservicedeadline, -sigservicelanes and -sigservicebuffers
# defaults (node/node.py), the service's backend there
SERVICE_ARGS = {"deadline_ms": 4.0, "lanes": 2046, "buffers": 2}
SYNC_WORKERS = 8        # the synchronous control's threads
BAD_EVERY = 64          # every 64th ECDSA record checks a message it did not sign
# the Schnorr levels: under msm a flush below CPU_FLOOR, and a bisection
# leaf of MSM_MIN_BATCH lanes or fewer, take the per-lane Python oracle
# (about 0.26 s a signature on the card's host), so the closed-loop
# levels, whose flushes are a few lanes, a forged lane (its bisection
# leaf: 8 oracle verifies) and a control over every transaction would
# time the oracle: msm runs the saturation level on valid signatures, and
# its control is a sample of this many transactions; after the timed run,
# untimed, the same signatures with one forged go through the same service
# in one flush (2 x 2,000 + 1 terms: the 4,096-term MSM), and exactly that
# lane must come back False
SCHNORR_LEVELS = ("saturation",)
SCHNORR_SYNC_TXS = 8
STORM_CHAINS = 100      # parent -> child chains in the node's storm
STORM_SCHNORR = 4       # Schnorr-signed transactions in the node's storm
NODE_WAVES = (("first", 8), ("second", 64))
DAEMON_STORM_TXS = 64
DAEMON_CLIENTS = 8


class FlushLog:
    """The lanes of each flush the signature service makes while in the
    with block: ops/ecdsa_batch.dispatch_batch wrapped (the service calls
    it through the module), recording the calls made on the service's
    thread ("sigservice"; the flushes here hold one algorithm each, so
    dispatch_batch does not call itself). It relies on the service's
    thread name and on the service calling dispatch_batch as a module
    attribute; a flush made inline on a submitter is not seen."""

    def __enter__(self):
        import threading

        from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E

        self.E, self.real, self.lanes = E, E.dispatch_batch, []

        def recorded(records, backend="auto", kernel=None):
            if threading.current_thread().name == "sigservice":
                self.lanes.append(len(records))
            return self.real(records, backend=backend, kernel=kernel)

        E.dispatch_batch = recorded
        return self

    def __exit__(self, *exc):
        self.E.dispatch_batch = self.real

    def summary(self) -> dict:
        from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E

        lanes = self.lanes
        return {"flushes": len(lanes),
                "lanes_min": min(lanes, default=0),
                "lanes_median": statistics.median(lanes) if lanes else 0,
                "lanes_max": max(lanes, default=0),
                "under_cpu_floor": sum(n < E.CPU_FLOOR for n in lanes),
                "under_cpu_floor_lanes": sum(n for n in lanes
                                             if n < E.CPU_FLOOR)}


def _ms_quantile(lat: list, q: float) -> float:
    s = sorted(lat)
    return s[min(len(s) - 1, int(q * len(s)))] * 1e3 if s else 0.0


def _threads(fn, n: int) -> float:
    """Run fn(i) on n threads; the wall seconds from the first start to
    the last join."""
    import threading

    errors = []

    def run(i):
        try:
            fn(i)
        except BaseException as e:  # re-raised on the caller below
            errors.append(e)

    pool = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    t0 = time.monotonic()
    for t in pool:
        t.start()
    for t in pool:
        t.join(600)
    wall = time.monotonic() - t0
    if any(t.is_alive() for t in pool):
        raise AssertionError("a serving thread did not finish")
    if errors:
        raise errors[0]
    return wall


def sync_control(txs: list, workers: int = SYNC_WORKERS) -> dict:
    """The -sigservice=off shape: verify_batch(backend="cpu") a
    transaction on ``workers`` threads (the CPU engine: the native batch
    for ECDSA, the Python oracle for Schnorr); wall, tx/s, per-transaction
    latency quantiles and the verdicts in order."""
    import threading

    import numpy as np

    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E

    out = [None] * len(txs)
    lat = []
    lock = threading.Lock()
    todo = iter(range(len(txs)))

    def work(_i):
        while True:
            with lock:
                j = next(todo, None)
            if j is None:
                return
            t0 = time.monotonic()
            ok = E.verify_batch(txs[j], backend="cpu")
            dt = time.monotonic() - t0
            with lock:
                out[j] = ok
                lat.append(dt)

    wall = _threads(work, workers)
    return {"txs": len(txs), "wall_s": wall, "tx_per_s": len(txs) / wall,
            "p50_ms": _ms_quantile(lat, 0.5), "p99_ms": _ms_quantile(lat, 0.99),
            "verdicts": np.concatenate(out)}


def serviced_run(txs: list, kernel: str, submitters: int,
                 open_loop: bool, probe: list = None) -> dict:
    """The same transactions through a SigService at the node's settings
    (backend "auto", SERVICE_ARGS) under ``kernel``: each submitter a
    closed loop (submit, await) or, open loop, the whole share submitted,
    then awaited; counts zeroed just before the first submit and read
    after the last verdict, with each flush's lanes (FlushLog). Then,
    untimed and counted apart, the records ``probe`` (if given) in one
    submit through the same service: their verdicts and launch shapes."""
    import numpy as np

    from bitcoincashplus_tpu_torch.serving import SigService

    svc = SigService(backend="auto", kernel=kernel, **SERVICE_ARGS).start()
    out = [None] * len(txs)
    lat = []

    def work(i):
        mine = range(i, len(txs), submitters)
        if open_loop:
            futs = [(j, time.monotonic(), svc.submit(txs[j])) for j in mine]
            for j, t0, fut in futs:
                out[j] = fut.result()
                lat.append(time.monotonic() - t0)
        else:
            for j in mine:
                t0 = time.monotonic()
                out[j] = svc.submit(txs[j]).result()
                lat.append(time.monotonic() - t0)

    try:
        _zero_counts()
        with FlushLog() as flushes:
            wall = _threads(work, submitters)
        counts = _read_counts()
        fallbacks = {**_fallbacks(),
                     "kat_failures": counts["stats"]["kat_failures"]}
        stats = dict(svc.stats)
        running = svc.running()
        if probe is not None:
            _zero_counts()
            probe_got = svc.submit(probe).result()
            probe_counts = _read_counts()
    finally:
        svc.stop()
    st = counts["stats"]
    extra = {} if probe is None else {
        "probe": {"verdicts": probe_got,
                  "launch_shapes": probe_counts["launch_shapes"],
                  "msm_bisects": probe_counts["stats"]["msm_bisects"],
                  "flush_errors": svc.stats["flush_errors"]
                  - stats["flush_errors"]}}
    return {"txs": len(txs), "wall_s": wall, "tx_per_s": len(txs) / wall,
            "p50_ms": _ms_quantile(lat, 0.5), "p99_ms": _ms_quantile(lat, 0.99),
            "verdicts": np.concatenate(out), "running": running,
            "flushes": flushes.summary(), "flush_lanes": flushes.lanes,
            "service": {k: v for k, v in stats.items() if v},
            "launches": {k: v for k, v in counts["launches"].items() if v},
            "launch_shapes": counts["launch_shapes"],
            "fallbacks": fallbacks,
            "stats": {k: st[k] for k in ("dispatches", "sigs_verified",
                                         "reject_confirm_sigs",
                                         "degenerate_rechecks",
                                         "schnorr_cpu_sigs", "msm_bisects",
                                         "device_seconds", "buckets_used")},
            **extra}


def serving_level(kernel: str, level: tuple, seed: int) -> dict:
    """One level of one kernel: fresh records (2 a transaction; ECDSA with
    a bad lane every BAD_EVERY, or valid Schnorr signatures), the
    synchronous control and the serviced run. The checks: every verdict
    the host oracle's (the control's; for Schnorr the oracle's on the
    control's sample, and True, as signed, elsewhere; then the forged
    probe's lane False and every other True, through a 4,096-term MSM
    launch), no flush error, fault fallback, KAT failure or breaker
    fallback, the CPU engine's
    signatures exactly the lanes of the flushes under CPU_FLOOR, the
    service alive, each expected kernel launched (K9 under msm; at
    saturation a 2,048-lane launch under glv and w4)."""
    import numpy as np

    from bitcoincashplus_tpu_torch.crypto import secp256k1 as oracle
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord
    from bitcoincashplus_tpu_torch.workload import txstorm

    name, n_txs, submitters, open_loop = level
    schnorr = kernel == "msm"
    recs = txstorm.records(2 * n_txs, seed, schnorr=schnorr,
                           bad_every=0 if schnorr else BAD_EVERY)
    txs = [recs[i:i + 2] for i in range(0, len(recs), 2)]
    sync = sync_control(txs[:SCHNORR_SYNC_TXS] if schnorr else txs)
    probe = forged = None
    if schnorr:
        # the level's signatures again (the service here keeps no
        # sigcache, so none is a hit), one of them over a message it did
        # not sign
        forged = len(recs) // 2 + 1
        r = recs[forged]
        probe = list(recs)
        probe[forged] = SigCheckRecord(r.pubkey, r.r, r.s,
                                       (r.msg_hash + 1) % oracle.N,
                                       algo="schnorr")
    svc = serviced_run(txs, kernel, submitters, open_loop, probe)
    got, oracle = svc.pop("verdicts"), sync.pop("verdicts")
    sample = len(oracle)
    shapes = {(k, B): n for k, B, n in svc["launch_shapes"]}
    fb = svc["fallbacks"]
    checks = {
        "verdicts_equal_oracle": bool(np.array_equal(got[:sample], oracle)),
        "service_running": svc["running"],
        "no_flush_error": svc["service"].get("flush_errors", 0) == 0,
        "no_fault_fallback": fb["fault_fallback_sigs"] == 0,
        "no_kat_failure": fb["kat_failures"] == 0,
        "no_breaker_fallback": fb["breaker_fallback_calls"] == 0,
        "cpu_sigs_are_the_under_floor_flushes":
            fb["cpu_fallback_sigs"]
            == svc["flushes"]["under_cpu_floor_lanes"],
        "flushes_counted": svc["flushes"]["flushes"]
            == svc["service"].get("dispatches", 0),
    }
    if schnorr:
        checks["verdicts_as_signed"] = bool(got.all())
        checks["msm_launched"] = svc["launches"].get("msm", 0) > 0
        pr = svc.pop("probe")
        pgot = pr.pop("verdicts")
        pr["forged_lane"] = forged
        checks["probe_false_at_the_forged_lane_only"] = bool(
            not pgot[forged] and int(pgot.sum()) == len(probe) - 1)
        checks["probe_msm_at_4096"] = any(
            k == "msm" and B == 4096 and n >= 1
            for k, B, n in pr["launch_shapes"])
        checks["probe_no_flush_error"] = pr["flush_errors"] == 0
        svc["probe"] = pr
    else:
        checks["oracle_every_lane"] = sample == len(recs)
        checks["bad_lanes_false"] = int((~got).sum()) == len(recs) // BAD_EVERY
    if name == "saturation" and not schnorr:
        entry = "glv_dev_verify" if kernel == "glv" else "w4_verify_bytes"
        checks[f"{entry}_at_2048"] = shapes.get((entry, 2048), 0) >= 1
    return {"kernel": kernel, "level": name, "submitters": submitters,
            "open_loop": open_loop, "sync": sync, "serviced": svc,
            "checks": checks}


def serving_node_run(chain: str, st: dict, name: str, flags: dict,
                     block=None) -> dict:
    """The storm through an in-process Node (-regtest on a copy of the
    storm's chain, ``flags``) on the card: each NODE_WAVES wave from its
    threads, each Node.accept_to_mempool under cs_main (the RPC and P2P
    callers' hold), then the tampered transaction, then the Schnorr set.
    Counts zeroed just before the first wave, read after the tampered
    transaction (with each flush's lanes), the Schnorr set's apart. A
    serviced node then mines one block over its mempool; ``block`` (the
    serviced node's) is submitted to the node, closed after."""
    import threading

    from bitcoincashplus_tpu_torch.mempool import MempoolError
    from bitcoincashplus_tpu_torch.mempool.accept import \
        accept_latency_quantiles
    from bitcoincashplus_tpu_torch.node.config import Config
    from bitcoincashplus_tpu_torch.node.node import Node
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.workload import txstorm

    d = f"{chain}_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(chain, d)
    cfg = Config()
    cfg.args.update(datadir=[d], regtest=["1"])
    for k, v in flags.items():
        cfg.args[k] = [str(v)]
    node = Node(config=cfg)
    rejects: dict = {}
    lock = threading.Lock()

    def feed(txs: list, threads: int) -> dict:
        todo = iter(txs)
        lat = []

        def work(_i):
            while True:
                with lock:
                    tx = next(todo, None)
                if tx is None:
                    return
                t0 = time.monotonic()
                try:
                    with node.cs_main:
                        node.accept_to_mempool(tx)
                except MempoolError as e:
                    with lock:
                        rejects[tx.txid_hex] = e.reason
                with lock:
                    lat.append(time.monotonic() - t0)

        wall = _threads(work, threads)
        return {"txs": len(txs), "threads": threads, "wall_s": wall,
                "tx_per_s": len(txs) / wall, "p50_ms": _ms_quantile(lat, 0.5),
                "p99_ms": _ms_quantile(lat, 0.99)}

    try:
        out = {"flags": " ".join(f"-{k}={v}" for k, v in flags.items())
               or "the defaults", "serviced": node.sigservice is not None}
        _zero_counts()
        with FlushLog() as flushes:
            out["waves"] = {w: feed(st[w], threads) for w, threads in NODE_WAVES}
            out["waves"]["tampered"] = feed([st["tampered"]], 1)
        counts = _read_counts()
        out.update(
            flushes=flushes.summary(),
            launches={k: v for k, v in counts["launches"].items() if v},
            launch_shapes=counts["launch_shapes"],
            fallbacks={**_fallbacks(),
                       "kat_failures": counts["stats"]["kat_failures"]})
        schnorr0 = E.STATS.schnorr_cpu_sigs
        out["waves"]["schnorr"] = feed(st["schnorr"], 1)
        out["schnorr_oracle_sigs"] = E.STATS.schnorr_cpu_sigs - schnorr0
        out["accept_quantiles"] = accept_latency_quantiles()
        out["pool"] = sorted(tx.hex() for tx in node.mempool.entries)
        out["rejects"] = dict(rejects)
        if node.sigservice is not None:
            snap = node.sigservice.snapshot()
            out["sigservice"] = {k: v for k, v in snap.items()
                                 if k != "watchdog"}
            spk = txstorm.chain_key().p2pkh_script()
            t0 = time.monotonic()
            (h,) = node.generate_to_script(spk, 1)
            out["mine_s"] = time.monotonic() - t0
            out["block"] = node.chainstate.get_block(h)
            out["pool_after_block"] = len(node.mempool.entries)
        if block is not None:
            t0 = time.monotonic()
            out["submit_block"] = node.submit_block(block)
            out["submit_s"] = time.monotonic() - t0
        out["tip"] = node.chainstate.tip().hash.hex()
        return out
    finally:
        node.close()
        shutil.rmtree(d, ignore_errors=True)


def serving_node_phase(workdir: str) -> dict:
    """Phase 5e(b): the storm (workload/txstorm over a storm_chain's
    fan-out outputs) through a serviced Node (the defaults:
    -sigservice=on, GLV, backend auto) and a control Node (-sigservice=off
    -tpu=0), one after the other; the serviced node's block connected on
    the control node."""
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.workload import txstorm

    chain = os.path.join(workdir, "storm_chain")
    t0 = time.monotonic()
    txstorm.storm_chain(chain)
    st = txstorm.storm(txstorm.spendable(chain), STORM_CHAINS, STORM_SCHNORR,
                       seed=1307)
    build_s = time.monotonic() - t0
    sv = serving_node_run(chain, st, "serviced", {})
    block = sv.pop("block")
    ct = serving_node_run(chain, st, "control",
                          {"sigservice": "off", "tpu": "0"}, block)
    runs = {"serviced": sv, "control": ct}
    tampered = st["tampered"].txid_hex
    every = st["first"] + st["second"] + st["schnorr"]
    fb = sv["fallbacks"]
    launched = sv["launches"]
    checks = {
        "mempools_equal": sv["pool"] == ct["pool"],
        "every_good_tx_admitted": sv["pool"] == sorted(
            tx.txid.hex() for tx in every),
        "tampered_rejected_on_both": sv["rejects"] == ct["rejects"] == {
            tampered: "mandatory-script-verify-flag-failed"},
        "block_connects_on_control": ct["submit_block"] is None,
        "same_tip": ct["tip"] == block.get_hash().hex() == sv["tip"],
        "block_drained_the_pool": sv["pool_after_block"] == 0,
        "no_flush_error": sv["sigservice"]["flush_errors"] == 0,
        "service_running": sv["sigservice"]["running"],
        "no_fault_fallback": fb["fault_fallback_sigs"] == 0,
        "no_kat_failure": fb["kat_failures"] == 0,
        "no_breaker_fallback": fb["breaker_fallback_calls"] == 0,
        "cpu_sigs_are_the_under_floor_flushes":
            fb["cpu_fallback_sigs"] == sv["flushes"]["under_cpu_floor_lanes"],
        "no_w4_launch": not any(launched.get(k, 0) for k in W4_ENTRIES),
        "control_no_launch": not ct["launches"],
        "schnorr_to_the_oracle": sv["schnorr_oracle_sigs"]
            == 2 * STORM_SCHNORR,
    }
    return {"build_s": build_s, "txs": len(every) + 1,
            "block_txs": len(block.vtx) - 1, "runs": runs, "checks": checks,
            "cpu_floor": E.CPU_FLOOR}


def serving_drill(seed: int = 1350) -> dict:
    """Phase 5e(d): the GLV entry made unavailable (ops/cuda_build.entry
    replaced by one that raises KernelUnavailable for glv_dev_verify*):
    SigService(...).submit(...).result() must raise KernelUnavailable and
    the service thread die, with no signature verified on the CPU; then
    the entry restored and a new service's verdicts right again."""
    import numpy as np

    from bitcoincashplus_tpu_torch.ops import cuda_build
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.serving import SigService
    from bitcoincashplus_tpu_torch.workload import txstorm

    recs = txstorm.records(16, seed, bad_every=4)
    real = cuda_build.entry

    def unavailable(name, argtypes):
        if name.startswith("glv_dev_verify"):
            raise cuda_build.KernelUnavailable(
                f"{name}: made unavailable for the drill")
        return real(name, argtypes)

    _zero_counts()
    svc = SigService(backend="auto", kernel="glv", **SERVICE_ARGS).start()
    thread, raised = svc._thread, None
    cuda_build.entry = unavailable
    try:
        try:
            svc.submit(recs).result()
        except cuda_build.KernelUnavailable as e:
            raised = f"{type(e).__name__}: {e}"
        thread.join(10)
        dead = not thread.is_alive() and not svc.running()
        errors = svc.stats["flush_errors"]
    finally:
        cuda_build.entry = real
        svc.stop()
    cpu = E.STATS.cpu_fallback_sigs + E.STATS.fault_fallback_sigs
    svc = SigService(backend="auto", kernel="glv", **SERVICE_ARGS).start()
    try:
        after = svc.submit(recs).result()
    finally:
        svc.stop()
    want = np.array([i % 4 != 3 for i in range(len(recs))])
    return {"raised": raised, "thread_dead": dead, "flush_errors": errors,
            "checks": {"raised": raised is not None, "thread_dead": dead,
                       "one_flush_error": errors == 1,
                       "nothing_on_the_cpu": cpu == 0,
                       "restored_verdicts": bool(np.array_equal(after, want))}}


def serving_phase(workdir: str) -> dict:
    """Phase 5e: the live-traffic path on the card. (a) the service
    levels under glv and w4, the Schnorr levels under msm, each beside its
    synchronous control; (b) the node's storm; (d) the drill. Each part's
    wall is logged; (c) runs inside the daemon phase."""
    t0 = time.monotonic()
    levels = []
    for k, kernel in enumerate(("glv", "w4", "msm")):
        for i, level in enumerate(SERVING_LEVELS):
            if kernel == "msm" and level[0] not in SCHNORR_LEVELS:
                continue
            levels.append(serving_level(kernel, level, 1310 + 10 * k + i))
    t1 = time.monotonic()
    node = serving_node_phase(workdir)
    t2 = time.monotonic()
    drill = serving_drill()
    return {"levels": levels, "node": node, "drill": drill,
            "walls_s": {"levels": t1 - t0, "node": t2 - t1,
                        "drill": time.monotonic() - t2}}


def serving_report(sv: dict, cases: dict, msm_rows: list) -> None:
    """Log phase 5e's results and fail on any of its checks. The card's
    busy time of a level is estimated as each launch shape's count x its
    time measured in phases 2 and 2c (``cases``, ``msm_rows``)."""
    def launched_ms(shapes) -> float:
        return sum(n * next(r["ms"] for r in (
            msm_rows if name == "msm" else cases[name])
            if r.get("M", r.get("B")) == B) for name, B, n in shapes)

    failed = []
    for row in sv["levels"]:
        sy, se = row["sync"], row["serviced"]
        se["kernel_ms_est"] = launched_ms(se["launch_shapes"])
        se["busy_share_est"] = se["kernel_ms_est"] / 1e3 / se["wall_s"]
        log(f"serving {row['kernel']} {row['level']} ({se['txs']} txs, "
            f"{row['submitters']} submitter(s), "
            f"{'open' if row['open_loop'] else 'closed'} loop): serviced "
            f"{se['tx_per_s']:.1f} tx/s, p50 {se['p50_ms']:.3f} ms, p99 "
            f"{se['p99_ms']:.3f} ms; synchronous control ({SYNC_WORKERS} "
            f"workers, {sy['txs']} txs) {sy['tx_per_s']:.1f} tx/s, p50 "
            f"{sy['p50_ms']:.3f} ms, p99 {sy['p99_ms']:.3f} ms; flushes "
            f"{se['flushes']} by reason "
            f"{ {k: v for k, v in se['service'].items() if k.startswith('flush_')} }"
            f"; launches {se['launch_shapes']} (the card busy about "
            f"{se['kernel_ms_est']:.3f} ms = {100 * se['busy_share_est']:.2f}% "
            f"of the wall); fallbacks {se['fallbacks']}; stats {se['stats']}")
        failed += [f"serving {row['kernel']} {row['level']}: {k}"
                   for k, v in row["checks"].items() if not v]
    node = sv["node"]
    for name, run in node["runs"].items():
        log(f"serving node {name} ({run['flags']}): waves "
            f"{json.dumps(run['waves'])}; accept quantiles "
            f"{run['accept_quantiles']}; flushes {run['flushes']}; launches "
            f"{run['launch_shapes']}; fallbacks {run['fallbacks']}; "
            f"{len(run['pool'])} txs in the pool; rejects {run['rejects']}"
            + (f"; sigservice {json.dumps(run['sigservice'])}; mined one "
               f"block of {node['block_txs']} txs in {run['mine_s']:.3f} s"
               if "sigservice" in run else
               f"; the serviced node's block: {run['submit_block']} in "
               f"{run['submit_s']:.3f} s"))
    failed += [f"serving node: {k}" for k, v in node["checks"].items()
               if not v]
    log(f"serving drill: {json.dumps(sv['drill'])}")
    failed += [f"serving drill: {k}" for k, v in sv["drill"]["checks"].items()
               if not v]
    log(f"serving: storm built in {node['build_s']:.1f} s; phase walls "
        f"{ {k: round(v, 1) for k, v in sv['walls_s'].items()} } s")
    if failed:
        raise AssertionError(f"serving checks failed: {failed}")


def daemon_storm(rpc, port: int, datadir: str, timeout: float) -> dict:
    """Phase 8's live traffic: three mature coinbases of the chain (they
    pay workload/sigchain's key) fanned out into 44 outputs each by
    sendrawtransaction and mined (generatetoaddress 1), then
    DAEMON_STORM_TXS 2-input transactions spending them sent to
    sendrawtransaction from DAEMON_CLIENTS client threads (a client
    each: the server answers each connection on a thread of its own);
    gettpuinfo's serving section and fallback counters before and
    after."""
    import threading

    from bitcoincashplus_tpu_torch.consensus.block import CBlock
    from bitcoincashplus_tpu_torch.consensus.tx import COutPoint
    from bitcoincashplus_tpu_torch.rpc.client import RPCClient
    from bitcoincashplus_tpu_torch.workload import txstorm

    spk = txstorm.chain_key().p2pkh_script()
    height = rpc.getblockcount()
    coinbases = []
    for h in range(1, height + 2 - 100):
        cb = CBlock.from_bytes(bytes.fromhex(
            rpc.getblock(rpc.getblockhash(h), 0))).vtx[0]
        if cb.vout[0].script_pubkey == spk and \
                rpc.gettxout(cb.txid_hex, 0) is not None:
            coinbases.append((COutPoint(cb.txid, 0), cb.vout[0].value))
        if len(coinbases) == 3:
            break
    if len(coinbases) < 3:
        raise AssertionError(f"{len(coinbases)} mature coinbases of the "
                             f"chain's key unspent at height {height}")
    fans = [txstorm.spend([cb], n_out=44) for cb in coinbases]
    for tx in fans:
        rpc.sendrawtransaction(tx.serialize().hex())
    rpc.generatetoaddress(1, rpc.getnewaddress())
    outs = [o for tx in fans for o in txstorm.outputs_of(tx)]
    txs = [txstorm.spend(outs[2 * i:2 * i + 2])
           for i in range(DAEMON_STORM_TXS)]

    def counters() -> dict:
        info = rpc.gettpuinfo()
        return {"serving": {k: v for k, v in info["serving"].items()
                            if k != "watchdog"},
                "cpu_fallback_sigs": info["batch"]["cpu_fallback_sigs"],
                "fault_fallback_sigs": info["batch"]["fault_fallback_sigs"],
                "breaker_fallback_calls": sum(
                    b["fallback_calls"] for b in info["breakers"].values())}

    before = counters()
    answers, lat = {}, []
    lock = threading.Lock()

    def work(i):
        client = RPCClient(port=port, datadir=os.path.join(datadir, "regtest"),
                           timeout=timeout)
        for tx in txs[i::DAEMON_CLIENTS]:
            t0 = time.monotonic()
            got = client.sendrawtransaction(tx.serialize().hex())
            with lock:
                lat.append(time.monotonic() - t0)
                answers[tx.txid_hex] = got

    wall = _threads(work, DAEMON_CLIENTS)
    after = counters()
    pool = set(rpc.getrawmempool())
    sv0, sv1 = before["serving"], after["serving"]
    delta = {k: sv1[k] - sv0[k] for k in (
        "submits", "lanes_enqueued", "dispatches", "lanes_real", "flush_full",
        "flush_deadline", "flush_kick", "flush_stop", "flush_errors",
        "overlapped_flushes", "deadline_misses", "timeouts")}
    checks = {
        "every_tx_answered_with_its_txid": len(answers) == len(txs) and all(
            answers.get(tx.txid_hex) == tx.txid_hex for tx in txs),
        "every_tx_in_the_mempool": {tx.txid_hex for tx in txs} <= pool,
        "service_flushed": delta.get("dispatches", 0) >= 1,
        "storm_no_flush_error": sv1["flush_errors"] == 0,
        "storm_no_fault_fallback": after["fault_fallback_sigs"] == 0,
        "storm_no_breaker_fallback": after["breaker_fallback_calls"] == 0,
    }
    return {"txs": len(txs), "clients": DAEMON_CLIENTS, "wall_s": wall,
            "tx_per_s": len(txs) / wall,
            "p50_ms": _ms_quantile(lat, 0.5), "p99_ms": _ms_quantile(lat, 0.99),
            "serving_delta": delta, "serving": sv1,
            "cpu_fallback_sigs_delta": after["cpu_fallback_sigs"]
            - before["cpu_fallback_sigs"], "checks": checks}


# ---- the sharded paths (K13) ---------------------------------------------------

# the sharded signature batch: dispatch_packed's slice, one 8192-lane bucket
# at width 1 and four of 2048 on [cuda:0] * 4
SHARD_SIGS = 8190
# the reuse checks' smaller batches: the same lanes a shard as SHARD_SIGS
# at widths 1 and 4 (8,192 and 2,048), and fewer (2,048 and 1,024)
SHARD_SAME, SHARD_FEWER = 7200, 2000
# the sharded MSM's inputs: msm_inputs at the buckets of 2,046 and 8,190
# Schnorr signatures (2n + 1 terms)
SHARD_MSM = ((4096, 2046), (16384, 8190))
# the reuse check's smaller MSM batch: 4,096 and 1,024 terms a shard at
# widths 1 and 4, as SHARD_MSM's first size
SHARD_MSM_SMALL = 3000
SHARD_REPS = 10
# the sharded sweep's wrapping window: 2^30 nonces from 2^32 - 2^28 (at
# width 4, stripes of 2^28: the first below 2^32, the rest past the wrap)
WRAP_START, WRAP_NONCES = (1 << 32) - (1 << 28), 1 << 30


def shard_layouts(dev) -> dict:
    """The layouts the sharded phases run: the default (chip_mesh(): every
    card, one on a one-card host) and four shards on the first card, each
    on a stream of its own."""
    import torch

    from bitcoincashplus_tpu_torch.parallel import mesh

    if dev.type == "cpu":  # the rehearsal: one shard, and four
        return {"chip_mesh()": mesh.chip_mesh(1),
                "[cpu] * 4": [torch.device("cpu")] * 4}
    return {"chip_mesh()": mesh.chip_mesh(),
            "[cuda:0] * 4": [torch.device("cuda", 0)] * 4}


def card(dev, launches):
    """The launches a check expects: ``launches`` on the card; none on a
    CPU device, whose plain versions count nothing (the rehearsal)."""
    return launches if dev.type == "cuda" else type(launches)()


def wall_ms(fn, dev, reps: int) -> float:
    """Median host ms of one synchronised call over ``reps`` calls after a
    warm-up (the sharded calls end in a host fold, so the host clock)."""
    fn()
    return statistics.median(time_once(fn, dev)[0] for _ in range(reps))


def staged(c: int, arrays: list) -> None:
    """A staging fill that leaves the rows the last call staged: a sharded
    call as the main path makes it once its pack has written them."""

# the parts of a sharded call's wall (parallel/mesh.PARTS), host clock
SHARD_PARTS = ("pack", "stage", "submit", "wait", "copy_back", "fold",
               "recheck")


def call_parts(fn, reps: int) -> dict:
    """The breakdown of a sharded call: over ``reps`` calls of ``fn`` after
    a warm-up, each with parallel/mesh.PARTS recording, the median host ms
    of each part of SHARD_PARTS (pack, staging copy, submission, the wait
    for the card, copy-back, fold, the host re-check), of the call's wall
    and of what no part covers ("other"), and the median over calls of
    the longest shard's kernel span from CUDA events ("kernel_ms")."""
    from bitcoincashplus_tpu_torch.parallel import mesh

    fn()
    rows = []
    for _ in range(reps):
        mesh.PARTS = {}
        try:
            t0 = time.perf_counter()
            fn()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            got, mesh.PARTS = mesh.PARTS, None
        row = {k: 1e3 * got.get(k, 0.0) for k in SHARD_PARTS}
        row["other"] = wall - sum(row.values())
        row["wall"] = wall
        row["kernel_ms"] = max(got.get("kernel_ms") or [0.0])
        rows.append(row)
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


def parts_text(parts: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in parts.items())


def timed_pack(pack, *args):
    """``pack(*args)`` with its host time recorded as the call's "pack"
    part (the host-split program's pack runs outside the shard call)."""
    from bitcoincashplus_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    out = pack(*args)
    mesh.note("pack", t0)
    return out


def _fallbacks() -> dict:
    from bitcoincashplus_tpu_torch.ops import dispatch
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E

    st = E.STATS.snapshot()
    return {"cpu_fallback_sigs": st["cpu_fallback_sigs"],
            "fault_fallback_sigs": st["fault_fallback_sigs"],
            "breaker_fallback_calls": sum(
                b["fallback_calls"] for b in dispatch.snapshot().values())}


def shard_bucket(n: int, width: int) -> int:
    """verify_batch_sharded's lanes a shard: 1024 and up, by 1024."""
    return max(1024, ((n + width - 1) // width + 1023) // 1024 * 1024)


def shard_records(n: int, seed: int) -> list:
    """glv_records (valid, forged every 4th, GLV-degenerate every 89th,
    w4-degenerate every 97th) with an out-of-range r (a q_inf lane) every
    37th lane from lane 3."""
    from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord

    recs = glv_records(n, seed)
    for i in range(3, n, 37):
        r = recs[i]
        recs[i] = SigCheckRecord(r.pubkey, 0, r.s, r.msg_hash)
    return recs


# the sharded verify programs: (name, the per-shard entry, the pack, the
# reference function replaced)
SHARD_VERIFY = (
    ("sharded_glv_dev", "glv_dev_verify", "w4_bytes",
     "bitcoincashplus_tpu/parallel/sig_shard.py:101"),
    ("sharded_glv", "glv_verify", "glv",
     "bitcoincashplus_tpu/parallel/sig_shard.py:65"),
    ("sharded_w4", "w4_verify_bytes", "w4_bytes",
     "bitcoincashplus_tpu/parallel/sig_shard.py:133"),
)
GLV_NAMES = ("d1", "d2", "sg1", "sg2", "s1", "s2", "ydiff", "qx", "qy",
             "q_inf", "r0", "rn", "wrap")
W4_NAMES = ("u1", "u2", "qx", "qy", "q_inf", "r0", "rn", "wrap")


def shard_sig_phase(clock_hz: float, n: int = SHARD_SIGS, seed: int = 1300,
                    reps: int = SHARD_REPS) -> dict:
    """Phase 7a: verify_batch_sharded on n records (shard_records) under
    glv and w4 at each layout of shard_layouts, counts zeroed just before
    each call and read just after: one launch of the per-shard entry a
    shard at the shard's bucket, no other launch, no fallback; verdicts
    equal to the oracle's and the unsharded dispatch_batch's. The GLV
    host-split route through _sharded_glv at both layouts (its verdicts
    after the host re-check equal to the oracle's). Then per sharded
    program on the same packed arrays: the shard-level call's wall at
    each layout beside the unsharded wrapper's at the same lanes (both:
    host to device, launches, device to host, fold), the plain version's
    wall, and the per-shard entry's bound on these inputs."""
    import numpy as np
    import torch

    from bitcoincashplus_tpu_torch.ops import cuda_build
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S
    from bitcoincashplus_tpu_torch.parallel import sig_shard

    dev = cuda_build.device()
    lays = shard_layouts(dev)
    recs = shard_records(n, seed)
    oracle = host_oracle(recs)
    unsharded = {k: np.asarray(E.dispatch_batch(recs, backend="device",
                                                kernel=k).result())
                 for k in ("glv", "w4")}
    runs, checks = [], {}
    for kern, entry in (("glv", "glv_dev_verify"), ("w4", "w4_verify_bytes")):
        for lname, lay in lays.items():
            width = len(lay)
            per = shard_bucket(n, width)
            _zero_counts()
            t0 = time.monotonic()
            got = sig_shard.verify_batch_sharded(recs, width, kernel=kern,
                                                 devices=lay)
            wall = time.monotonic() - t0
            counts = _read_counts()
            key = f"{kern} {lname}"
            runs.append({"kernel": kern, "layout": lname, "width": width,
                         "wall_s": wall, "launches": {
                             k: v for k, v in counts["launches"].items() if v},
                         "launch_shapes": counts["launch_shapes"],
                         "degenerate_rechecks":
                             counts["stats"]["degenerate_rechecks"],
                         "fallbacks": _fallbacks()})
            checks.update({
                f"{key} oracle": np.array_equal(got, oracle),
                f"{key} unsharded": np.array_equal(got, unsharded[kern]),
                f"{key} one launch a shard": counts["launch_shapes"]
                == card(dev, [[entry, per, width]]),
                f"{key} no fallback": not any(_fallbacks().values())})
    # the kept staging reused: at each layout and kernel, another batch,
    # a smaller one at the same lanes a shard, one at fewer lanes, then
    # the first again, each call's verdicts its own oracle's; and the
    # planes of the smaller batch after the larger one at the same lanes:
    # its padding lanes report nothing, its fails are its own
    other = shard_records(n, seed + 1)
    other_oracle = host_oracle(other)
    seq = ((other, other_oracle), (other[:SHARD_SAME], other_oracle[
        :SHARD_SAME]), (recs[:SHARD_FEWER], oracle[:SHARD_FEWER]),
        (recs, oracle))
    for kern, name in (("glv", "glv_dev"), ("w4", "w4")):
        for lname, lay in lays.items():
            width, per = len(lay), shard_bucket(n, len(lay))
            checks[f"reuse {kern} {lname} verdicts"] = all(
                np.array_equal(sig_shard.verify_batch_sharded(
                    r, width, kernel=kern, devices=lay), want)
                for r, want in seq)
            sig_shard.verify_batch_sharded(other, width, kernel=kern,
                                           devices=lay)
            small = other[:SHARD_SAME]
            ok, degen, fails = sig_shard._verify_shards(
                name, sig_shard._pack_rows(E.pack_records_w4_bytes, small,
                                           per), "pack", per, lay)
            qinf = E.pack_records_w4_bytes(small, per * width)[4]
            k = len(small)
            checks[f"reuse {kern} {lname} padding planes"] = (
                not ok[k:].any() and not degen[k:].any()
                and fails == int(((~ok | degen) & (qinf == 0)).sum())
                and np.array_equal(np.where(degen[:k], other_oracle[:k],
                                            ok[:k]), other_oracle[:k]))
    # the host-split route: the shard-level function itself
    host = {}
    for lname, lay in lays.items():
        width = len(lay)
        per = shard_bucket(n, width)
        arrays = E.pack_records_glv(recs, per * width)
        _zero_counts()
        ok, degen, fails = sig_shard._sharded_glv(*arrays, devices=lay)
        counts = _read_counts()
        final = np.where(degen[:n], oracle, ok[:n])
        host[lname] = {"launch_shapes": counts["launch_shapes"],
                       "degen_lanes": int(degen[:n].sum()), "fails": fails}
        checks.update({
            f"glv host split {lname} oracle": np.array_equal(final, oracle),
            f"glv host split {lname} one launch a shard":
                counts["launch_shapes"] == card(dev, [["glv_verify", per,
                                                       width]]),
            f"glv host split {lname} degen lanes": bool(degen[:n].any())})
    # the timing rows, per sharded program, on its packed arrays (each
    # layout's lanes: 8,192 at both for 8,190 records) beside the
    # unsharded wrapper at the width-1 bucket
    B = shard_bucket(n, 1)
    progs = {}
    for name, entry, pack, replaces in SHARD_VERIFY:
        packer = (E.pack_records_glv if pack == "glv"
                  else E.pack_records_w4_bytes)
        shard_fn = getattr(sig_shard, "_" + name)
        wrapper, plain = {
            "glv_dev_verify": (S.ecdsa_verify_batch_glv_dev,
                               S.glv_dev_verify_plain),
            "glv_verify": (S.ecdsa_verify_batch_glv, S.glv_verify_plain),
            "w4_verify_bytes": (S.ecdsa_verify_batch_pallas_w4_bytes,
                                S.w4_verify_bytes_plain)}[entry]
        ms, parts = {}, {}
        for lname, lay in lays.items():
            lanes = shard_bucket(n, len(lay)) * len(lay)
            packed = packer(recs, lanes)
            ms[lname] = wall_ms(lambda lay=lay, packed=packed: shard_fn(
                *packed, devices=lay), dev, reps)
            # the same call from rows already staged, as the main path's
            # pack leaves them
            ms[f"{lname} staged"] = wall_ms(
                lambda lay=lay, lanes=lanes: sig_shard._verify_shards(
                    name[len("sharded_"):], staged, "stage",
                    lanes // len(lay), lay), dev, reps)
            # the breakdown of the main path's call at this layout (the
            # host split: its pack, then the shard-level call)
            if pack == "glv":
                call = (lambda lay=lay, lanes=lanes: shard_fn(
                    *timed_pack(packer, recs, lanes), devices=lay))
            else:
                call = (lambda lay=lay, kern={"sharded_glv_dev": "glv",
                                              "sharded_w4": "w4"}[name]:
                        sig_shard.verify_batch_sharded(
                            recs, len(lay), kernel=kern, devices=lay))
            parts[lname] = call_parts(call, reps)
        packed = packer(recs, B)
        arrays = dict(zip(GLV_NAMES if pack == "glv" else W4_NAMES,
                          [np.ascontiguousarray(a) for a in packed]))
        on_dev = lambda: [torch.from_numpy(a).to(dev) for a in packed]
        ms["unsharded"] = wall_ms(
            lambda: [t.cpu() for t in wrapper(*on_dev())], dev, reps)
        tens = on_dev()
        plain_ms, plain_out = time_once(lambda: plain(*tens), dev)
        ok_k, dg_k = wrapper(*tens)
        same = (np.array_equal(dg_k.cpu().numpy(), plain_out[1].cpu().numpy())
                and np.array_equal(ok_k.cpu().numpy()[~dg_k.cpu().numpy()],
                                   plain_out[0].cpu().numpy()[
                                       ~dg_k.cpu().numpy()]))
        checks[f"{name} unsharded equal to the plain version"] = same
        progs[name] = {"entry": entry, "replaces": replaces, "B": B,
                       "ms": ms, "parts": parts, "plain_ms": plain_ms,
                       "wrapper": wrapper,
                       **verify_bound(entry, arrays, B, clock_hz)}
    # a batch of four cards' waves: the records tiled four times (8,192
    # lanes a shard at width 4), at each layout of width 4, beside the
    # unsharded wrapper on one card at the same lanes
    recs4, oracle4 = recs * 4, np.tile(oracle, 4)
    lays4 = {k: v for k, v in lays.items() if len(v) == 4}
    wave = {"n": len(recs4), "runs": [], "programs": {}}
    for kern, entry in (("glv", "glv_dev_verify"), ("w4", "w4_verify_bytes")):
        for lname, lay in lays4.items():
            per = shard_bucket(len(recs4), 4)
            _zero_counts()
            got = sig_shard.verify_batch_sharded(recs4, 4, kernel=kern,
                                                 devices=lay)
            counts = _read_counts()
            key = f"four waves {kern} {lname}"
            wave["runs"].append({"kernel": kern, "layout": lname,
                                 "launch_shapes": counts["launch_shapes"]})
            checks.update({
                f"{key} oracle": np.array_equal(got, oracle4),
                f"{key} one launch a shard": counts["launch_shapes"]
                == card(dev, [[entry, per, 4]]),
                f"{key} no fallback": not any(_fallbacks().values())})
    B4 = shard_bucket(len(recs4), 1)
    for name, entry, pack, _replaces in SHARD_VERIFY:
        packer = (E.pack_records_glv if pack == "glv"
                  else E.pack_records_w4_bytes)
        shard_fn = getattr(sig_shard, "_" + name)
        wrapper = progs[name]["wrapper"]
        per4 = shard_bucket(len(recs4), 4)
        packed = packer(recs4, per4 * 4)
        ms = {}
        for lname, lay in lays4.items():
            ms[lname] = wall_ms(lambda lay=lay: shard_fn(*packed, devices=lay),
                                dev, reps)
            ms[f"{lname} staged"] = wall_ms(
                lambda lay=lay: sig_shard._verify_shards(
                    name[len("sharded_"):], staged, "stage", per4, lay),
                dev, reps)
        one = packer(recs4, B4)
        ms["unsharded"] = wall_ms(lambda: [t.cpu() for t in wrapper(*[
            torch.from_numpy(a).to(dev) for a in one])], dev, reps)
        wave["programs"][name] = {"B": B4, "ms": ms, "parts": {
            lname: call_parts(lambda lay=lay: shard_fn(*packed, devices=lay),
                              reps) for lname, lay in lays4.items()}}
    for r in progs.values():
        r.pop("wrapper")
    return {"n": n, "runs": runs, "host_split": host, "programs": progs,
            "four_waves": wave, "checks": checks}


def _terms(xm, ym, inf8, km) -> list:
    """The (x, y, k) terms of packed MSM arrays, flagged lanes left out
    (they add nothing)."""
    return [(int.from_bytes(xm[j].tobytes(), "big"),
             int.from_bytes(ym[j].tobytes(), "big"),
             int.from_bytes(km[j].tobytes(), "big"))
            for j in range(len(inf8)) if not inf8[j]]


def logged_terms(m: int, seed: int) -> tuple:
    """m terms k_j (c + j) G of known discrete logs (consecutive, so the
    points are a chain of adds), and those logs."""
    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O

    rng = random.Random(seed)
    c = rng.randrange(1, O.N - m)
    pt, terms = O.point_mul(c, O.G), []
    for _ in range(m):
        terms.append((pt[0], pt[1], rng.randrange(1, O.N)))
        pt = O.point_add(pt, O.G)
    return terms, [c + j for j in range(m)]


def logged_sum(terms, logs):
    """The host's sum of terms of known logs (None: infinity)."""
    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O

    total = sum(k * lg for (_, _, k), lg in zip(terms, logs)) % O.N
    return O.point_mul(total, O.G) if total else None


def shard_msm_phase(clock_hz: float, sizes=SHARD_MSM, seed: int = 1400,
                    reps: int = SHARD_REPS) -> dict:
    """Phase 7b: msm_is_infinity_sharded on the terms of msm_inputs at
    each size (its sum nonzero and zero) at each layout, counts zeroed
    just before each call and read just after: one msm_partial launch a
    shard, the verdict equal to schnorr_msm_is_infinity's on the packed
    inputs and to the host's sum. 100 terms at width 4 through
    _sharded_msm: shards 2 and 3 hold only padding and are at infinity,
    each partial the host's sum of its shard's terms. Then at the first
    size: the shard-level call's wall (launches and the partials read
    back) at each layout beside the unsharded msm_partial_point's on the
    same terms, the plain version's wall, and the bound (msm_work of each
    shard's pack)."""
    import torch

    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O
    from bitcoincashplus_tpu_torch.ops import cuda_build
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S
    from bitcoincashplus_tpu_torch.parallel import sig_shard

    dev = cuda_build.device()
    lays = shard_layouts(dev)
    runs, checks = [], {}
    for M, sigs in sizes:
        for zero_sum in (False, True):
            xm, ym, inf8, km, want = msm_inputs(M, seed + M, zero_sum)
            terms = _terms(xm, ym, inf8, km)
            if M == sizes[0][0] and not zero_sum:
                first = terms
            one = int(S.schnorr_msm_is_infinity(
                *[torch.from_numpy(a).to(dev) for a in (xm, ym, inf8, km)])[0])
            for lname, lay in lays.items():
                width = len(lay)
                _zero_counts()
                t0 = time.monotonic()
                got = sig_shard.msm_is_infinity_sharded(terms, width,
                                                        devices=lay)
                wall = time.monotonic() - t0
                counts = _read_counts()
                per = E._msm_bucket_for(-(-len(terms) // width))
                key = f"M={M} zero={zero_sum} {lname}"
                runs.append({"M": M, "sigs": sigs, "terms": len(terms),
                             "zero_sum": zero_sum, "layout": lname,
                             "wall_s": wall, "verdict": got,
                             "launch_shapes": counts["launch_shapes"],
                             "fallbacks": _fallbacks()})
                checks.update({
                    f"{key} no fallback": not any(_fallbacks().values()),
                    f"{key} host": got is (want is None) is zero_sum,
                    f"{key} unsharded": int(got) == one,
                    f"{key} one launch a shard": counts["launch_shapes"]
                    == card(dev, [["msm_partial", per, width]])})
    # the kept staging reused: after the larger sizes, a smaller batch at
    # each layout (SHARD_MSM_SMALL terms of known logs: the first size's
    # lanes a shard at widths 1 and 4), its sum nonzero and zero, the
    # verdict the host's; then its shards' partials, each the host's sum
    # of that shard's terms (the last shard's padding at infinity)
    for zero_sum in (False, True):
        terms, logs = logged_terms(SHARD_MSM_SMALL, seed + 7)
        if zero_sum:
            rest = sum(k * lg for (_, _, k), lg in zip(terms[:-1], logs))
            x, y, _k = terms[-1]
            terms[-1] = (x, y, -rest * pow(logs[-1], -1, O.N) % O.N)
        want = logged_sum(terms, logs)
        for lname, lay in lays.items():
            checks[f"reuse zero={zero_sum} {lname} verdict"] = (
                sig_shard.msm_is_infinity_sharded(terms, len(lay),
                                                  devices=lay)
                is (want is None) is zero_sum)
    for lname, lay in lays.items():
        width = len(lay)
        per = E._msm_bucket_for(-(-SHARD_MSM_SMALL // width))
        sig_shard.msm_is_infinity_sharded(first, width, devices=lay)
        parts = sig_shard._msm_shards(sig_shard._pack_rows(
            E._msm_pack, terms, per), "pack", per, lay)
        good = True
        for c, ((x, y, z), inf) in enumerate(parts):
            want = logged_sum(terms[c * per:(c + 1) * per],
                              logs[c * per:(c + 1) * per])
            zi = pow(z, -1, O.P) if z else 0
            good &= (inf if want is None else not inf and (
                x * zi * zi % O.P, y * zi ** 3 % O.P) == want)
        checks[f"reuse {lname} shard partials"] = good
    # shards of padding alone: 100 terms at width 4 (bucket 64 a shard)
    terms, logs = logged_terms(100, seed)
    four = list(lays.values())[-1]
    parts = sig_shard._sharded_msm(*E._msm_pack(terms, 256), devices=four)
    pad = {"infinity": [inf for _, inf in parts]}
    checks["padding shards at infinity"] = pad["infinity"] == \
        [False, False, True, True]
    for c, ((x, y, z), _inf) in enumerate(parts[:2]):
        zi = pow(z, O.P - 2, O.P)
        checks[f"padding case shard {c} partial"] = \
            (x * zi * zi % O.P, y * zi ** 3 % O.P) == logged_sum(
                terms[64 * c:64 * (c + 1)], logs[64 * c:64 * (c + 1)])
    checks["padding case verdict"] = \
        sig_shard.msm_is_infinity_sharded(terms, 4, devices=four) is \
        (logged_sum(terms, logs) is None)
    # the timing row at the first size, nonzero sum
    M = sizes[0][0]
    xm, ym, inf8, km, _want = msm_inputs(M, seed + M, False)
    terms = _terms(xm, ym, inf8, km)
    ms, work, parts = {}, {}, {}
    for lname, lay in lays.items():
        width = len(lay)
        per = E._msm_bucket_for(-(-len(terms) // width))
        packed = E._msm_pack(terms, per * width)
        ms[lname] = wall_ms(lambda lay=lay, packed=packed:
                            sig_shard._sharded_msm(*packed, devices=lay),
                            dev, reps)
        ms[f"{lname} staged"] = wall_ms(
            lambda lay=lay, per=per: sig_shard._msm_shards(
                staged, "stage", per, lay), dev, reps)
        parts[lname] = call_parts(
            lambda lay=lay: sig_shard.msm_is_infinity_sharded(
                terms, len(lay), devices=lay), reps)
        work[lname] = [msm_work(packed[3][c * per:(c + 1) * per],
                                packed[2][c * per:(c + 1) * per])
                       for c in range(width)]
    packed = E._msm_pack(terms, E._msm_bucket_for(len(terms)))
    ms["unsharded"] = wall_ms(lambda: S.msm_partial_point(
        *[torch.from_numpy(a).to(dev) for a in packed]), dev, reps)
    ts = S._msm_tensors(*[torch.from_numpy(a).to(dev) for a in packed])
    plain_ms, _pt = time_once(lambda: S.msm_accumulate_plain(*ts), dev)
    lname1 = next(iter(lays))
    # each shard's least work: the fewer IMADs of msm_work's two schedules
    imads = sum(min(w["imads"], w["horner"]["imads"]) for w in work[lname1])
    nbytes = packed[0].shape[0] * (3 * 32 + 1) + 4 * S.MSM_WORDS
    row = {"M": packed[0].shape[0], "terms": len(terms), "ms": ms,
           "parts": parts, "plain_ms": plain_ms, "imads": imads,
           "imads_by_layout": {k: sum(w["imads"] for w in v)
                               for k, v in work.items()},
           **bound(imads, nbytes, clock_hz)}
    # a batch of four cards' waves: the last size's terms tiled four times
    # (4 S is zero exactly where S is), at each layout of width 4: one
    # launch a shard at the ladder's top bucket, the verdict the host's;
    # the shard-level call timed (one card takes the batch only as four
    # shards: the ladder stops at the last size)
    M = sizes[-1][0]
    lays4 = {k: v for k, v in lays.items() if len(v) == 4}
    wave = {"terms": None, "ms": {}, "parts": {}, "launches": 0}
    for zero_sum in (False, True):
        xm, ym, inf8, km, want = msm_inputs(M, seed + M, zero_sum)
        terms4 = _terms(xm, ym, inf8, km) * 4
        wave["terms"] = len(terms4)
        per = E._msm_bucket_for(-(-len(terms4) // 4))
        for lname, lay in lays4.items():
            _zero_counts()
            got = sig_shard.msm_is_infinity_sharded(terms4, 4, devices=lay)
            counts = _read_counts()
            wave["launches"] += sum(n for _e, _M, n in
                                    counts["launch_shapes"])
            key = f"four waves zero={zero_sum} {lname}"
            checks.update({
                f"{key} host": got is (want is None) is zero_sum,
                f"{key} one launch a shard": counts["launch_shapes"]
                == card(dev, [["msm_partial", per, 4]]),
                f"{key} no fallback": not any(_fallbacks().values())})
    packed = E._msm_pack(terms4, per * 4)
    wave["M"] = per * 4
    # the bound of the batch: each shard's fewer IMADs of msm_work's two
    # schedules and its bytes; all four shards' over one card, and the
    # largest shard's over its own card (the four-card call)
    shard_work = [msm_work(packed[3][c * per:(c + 1) * per],
                           packed[2][c * per:(c + 1) * per])
                  for c in range(4)]
    imads4 = [min(w["imads"], w["horner"]["imads"]) for w in shard_work]
    shard_bytes = per * (3 * 32 + 1) + 4 * S.MSM_WORDS
    wave["bound_one_card"] = bound(sum(imads4), 4 * shard_bytes, clock_hz)
    wave["bound_each_card"] = bound(max(imads4), shard_bytes, clock_hz)
    for lname, lay in lays4.items():
        wave["ms"][lname] = wall_ms(lambda lay=lay: sig_shard._sharded_msm(
            *packed, devices=lay), dev, reps)
        wave["ms"][f"{lname} staged"] = wall_ms(
            lambda lay=lay: sig_shard._msm_shards(staged, "stage", per, lay),
            dev, reps)
        wave["parts"][lname] = call_parts(
            lambda lay=lay: sig_shard.msm_is_infinity_sharded(
                terms4, 4, devices=lay), reps)
    return {"runs": runs, "padding": pad, "program": row,
            "four_waves": wave, "checks": checks}


def diff1_header(lo: int, hi: int, seed: int, tile: int,
                 bits: int = DIFF1_BITS) -> tuple:
    """A testnet header at nBits ``bits`` (the testnet genesis header, at
    difficulty 1, with a seeded merkle root) whose first hit from nonce 0,
    by the exact engine (ops/miner.sweep_header), lies in [lo, hi);
    (header, target, first hit, headers tried)."""
    from bitcoincashplus_tpu_torch.consensus.params import select_params
    from bitcoincashplus_tpu_torch.consensus.pow import compact_to_target
    from bitcoincashplus_tpu_torch.ops import miner

    base = select_params("test").genesis.header.serialize()
    base = base[:72] + bits.to_bytes(4, "little") + base[76:]
    target = compact_to_target(bits)[0]
    rng = random.Random(seed)
    for tried in range(1, 4097):
        hdr = base[:36] + rng.randbytes(32) + base[68:]
        first, _ = miner.sweep_header(hdr, target, 0, hi, tile)
        if first is not None and first >= lo:
            return hdr, target, first, tried
    raise AssertionError(f"no header with a first hit in [{lo}, {hi})")


def shard_nonce_phase(clock_hz: float, ops_exact: int, lo: int = 1 << 24,
                      hi: int = 1 << 27, tile: int = 1 << 16,
                      wrap=(WRAP_START, WRAP_NONCES), mine: bool = True,
                      bits: int = DIFF1_BITS, reps: int = 3) -> dict:
    """Phase 7c: sweep_header_sharded on a testnet difficulty-1 header
    (diff1_header) at each layout, counts zeroed just before each call
    and read just after (one sweep_exact launch a shard): from nonce 0
    over the whole space, the nonce equal to the exact engine's first
    hit; from wrap[0] over wrap[1] nonces (stripes past 2^32 wrap), each
    shard's tiles and hit equal to one unsharded launch over its stripe
    by the stripe rule, and the fold's nonce the least of them. Then one
    testnet block mined at each layout through generate_blocks(...,
    sweep=sweep_header_sharded), connected and host-verified. The walls:
    the from-0 call at each layout beside the unsharded exact engine's,
    the wrapping window at each layout, the plain version's on the
    width-1 launch; the bound: ALU-pipe instructions a nonce times the
    nonces that launch swept."""
    import functools

    from bitcoincashplus_tpu_torch.ops import cuda_build, miner
    from bitcoincashplus_tpu_torch.ops import sha256_sweep as SW
    from bitcoincashplus_tpu_torch.parallel import nonce_shard

    dev = cuda_build.device()
    lays = shard_layouts(dev)
    hdr, target, first, tried = diff1_header(lo, hi, 1500, tile, bits)
    runs, checks = [], {}

    def sharded(lname, lay, start, budget):
        _zero_counts()
        SW.reset_launch_counts()
        t0 = time.monotonic()
        out = nonce_shard.sweep_header_sharded(
            hdr, target, start, budget, tile=tile, devices=lay,
            return_per_chip=True)
        wall = time.monotonic() - t0
        checks[f"{lname} {start} no fallback"] = not any(
            _fallbacks().values())
        return out, wall, dict(SW.LAUNCHES)

    tmpl = SW.header_template(hdr, dev)
    tgt = miner.target_tensor(target, dev)
    for lname, lay in lays.items():
        width = len(lay)
        (nonce, hashes, per_chip), wall, launches = sharded(lname, lay, 0,
                                                            1 << 32)
        runs.append({"case": "from 0", "layout": lname, "nonce": nonce,
                     "hashes": hashes, "per_chip": per_chip, "wall_s": wall,
                     "launches": launches})
        checks[f"from 0 {lname} first hit"] = nonce == first
        checks[f"from 0 {lname} one launch a shard"] = \
            launches["sweep_exact"] == card(dev, width)
        start, budget = wrap
        (nonce, hashes, per_chip), wall, launches = sharded(lname, lay,
                                                            start, budget)
        n_tiles = max(1, budget // width // tile)
        stripes = [(start + c * n_tiles * tile) & 0xFFFFFFFF
                   for c in range(width)]
        ref = [miner.sweep(tmpl, tgt, st, n_tiles, tile).tolist()
               for st in stripes]
        hits = [nc for f, nc, _ in ref if f]
        runs.append({"case": "wrap", "layout": lname, "stripes": stripes,
                     "nonce": nonce, "hashes": hashes, "per_chip": per_chip,
                     "stripe_rule": ref, "wall_s": wall,
                     "launches": launches})
        checks[f"wrap {lname} stripe rule"] = (
            per_chip == [t for _, _, t in ref]
            and nonce == (min(hits) if hits else None)
            and hashes == sum(per_chip) * tile)
        checks[f"wrap {lname} one launch a shard"] = \
            launches["sweep_exact"] == card(dev, width)
    # the walls and the bound
    ms = {f"from 0 {lname}": wall_ms(
        lambda lay=lay: nonce_shard.sweep_header_sharded(
            hdr, target, 0, 1 << 32, tile=tile, devices=lay), dev, reps)
        for lname, lay in lays.items()}
    ms["from 0 unsharded"] = wall_ms(
        lambda: miner.sweep_header(hdr, target, 0, 1 << 32, tile), dev, reps)
    ms.update({f"wrap {lname}": wall_ms(
        lambda lay=lay: nonce_shard.sweep_header_sharded(
            hdr, target, wrap[0], wrap[1], tile=tile, devices=lay), dev,
        reps) for lname, lay in lays.items()})
    ms["wrap unsharded"] = wall_ms(lambda: miner.sweep(
        tmpl, tgt, wrap[0], wrap[1] // tile, tile).tolist(), dev, reps)
    n_tiles = (1 << 32) // tile
    plain_ms, plain = time_once(lambda: miner.sweep_exact_plain(
        tmpl, tgt, 0, n_tiles, tile).tolist(), dev)
    kernel = miner.sweep(tmpl, tgt, 0, n_tiles, tile).tolist()
    checks["from 0 plain version equal"] = plain == kernel
    nonces = kernel[2] * tile
    program = {"header_tried": tried, "first_hit": first, "ms": ms,
               "plain_ms": plain_ms, "nonces": nonces,
               "ops_per_nonce": ops_exact,
               **bound(ops_exact * nonces, 4 * 64 + 32 + 32, clock_hz)}
    blocks = {}
    if mine:
        blocks = {lname: mine_sharded(functools.partial(
            nonce_shard.sweep_header_sharded, devices=lay), tile)
            for lname, lay in lays.items()}
        checks.update({f"mined {k}": v["connected"]
                       for k, v in blocks.items()})
    return {"runs": runs, "program": program, "blocks": blocks,
            "checks": checks}


def mine_sharded(sweep, tile: int) -> dict:
    """One testnet block (difficulty 1) through generate_blocks with
    ``sweep`` on a fresh in-memory ChainstateManager: connected, its hash
    at or under its target; launches of sweep_exact counted."""
    from bitcoincashplus_tpu_torch.consensus.params import select_params
    from bitcoincashplus_tpu_torch.consensus.pow import compact_to_target
    from bitcoincashplus_tpu_torch.mining.generate import generate_blocks
    from bitcoincashplus_tpu_torch.ops import sha256_sweep as SW
    from bitcoincashplus_tpu_torch.store.blockstore import MemoryBlockStore
    from bitcoincashplus_tpu_torch.validation.chainstate import \
        ChainstateManager
    from bitcoincashplus_tpu_torch.validation.coins import MemoryCoinsView

    params = select_params("test")
    cs = ChainstateManager(params, MemoryCoinsView(), MemoryBlockStore(),
                           script_verifier=None)
    spk = bytes.fromhex("76a914") + bytes(range(20)) + bytes.fromhex("88ac")
    SW.reset_launch_counts()
    t0 = time.monotonic()
    hashes = generate_blocks(cs, spk, 1, MAX_TRIES, tile=tile, sweep=sweep)
    wall = time.monotonic() - t0
    hdr = cs.block_index[hashes[0]].header if hashes else None
    return {"wall_s": wall, "launches": SW.LAUNCHES["sweep_exact"],
            "bits": f"{hdr.bits:#010x}" if hdr else None,
            "connected": bool(hashes) and cs.tip().hash == hashes[0]
            and hdr.bits == DIFF1_BITS
            and _pow_hash(hdr.serialize(), hdr.nonce)
            <= compact_to_target(hdr.bits)[0]}


# ---- the daemon ------------------------------------------------------------------

# the port's kernels as a profiler trace names them (csrc/*.cu)
PORT_KERNEL_RE = (r"\b(glv|w4|msm|ladder|sweep|sha256d|merkle)_[a-z0-9_]*"
                  r"kernel\b")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def daemon_phase(chain_dir: str, tips: tuple, record: dict,
                 device: str = "cuda", timeout: float = 300.0) -> dict:
    """Phase 8: the port's daemon as users start it, python -m
    bitcoincashplus_tpu_torch.cli.bcpd -regtest -reindex on a copy of the
    node phase's chain (``device``: its -device=, the card by default; the
    default GLV kernel; -residentminer=off, so that generatetoaddress
    takes the h7-dispatch engine), driven over JSON-RPC: getblockchaininfo
    and gettxoutsetinfo (height, tip and muhash equal to ``record``, the
    -tpu=0 run's); gettpuinfo (the card's name in devices, glv, the
    watched programs, every fallback counter 0); startprofile, submitblock
    of the tampered tip (the tip stays; sent again, "duplicate-invalid")
    and of the good tip (accepted, the tip moves), stopprofile (the trace
    names a port kernel); one bcp_cli getblockcount; generatetoaddress 1;
    stop, and the process exits 0. The process is killed if anything
    fails."""
    import torch

    from bitcoincashplus_tpu_torch.rpc.client import RPCClient

    base = chain_dir + "_daemon"
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(chain_dir, base)
    rpc_port, p2p_port = _free_port(), _free_port()
    flags = ["-regtest", f"-datadir={base}", f"-rpcport={rpc_port}",
             f"-port={p2p_port}", "-residentminer=off", f"-device={device}"]
    env = dict(os.environ, PYTHONPATH=REPO)
    # the daemon's output goes to files: a pipe nobody drains would stall it
    logs = {k: open(f"{base}.{k}", "w+b") for k in ("stdout", "stderr")}
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "bitcoincashplus_tpu_torch.cli.bcpd",
         "-reindex", *flags], cwd=REPO, env=env, stdout=logs["stdout"],
        stderr=logs["stderr"])
    out: dict = {"flags": " ".join(flags + ["-reindex"])}
    checks = {}

    def tail(k: str) -> str:
        logs[k].seek(0)
        return logs[k].read().decode(errors="replace")[-3000:]

    try:
        while "bcpd started" not in tail("stdout"):
            if proc.poll() is not None or time.monotonic() - t0 > timeout:
                raise AssertionError(f"bcpd did not start (rc {proc.poll()})"
                                     f": {tail('stderr')}")
            time.sleep(0.1)
        out["started_s"] = time.monotonic() - t0
        out["started_line"] = tail("stdout").strip().splitlines()[-1]
        rpc = RPCClient(port=rpc_port, datadir=os.path.join(base, "regtest"),
                        timeout=timeout)
        info, utxo = rpc.getblockchaininfo(), rpc.gettxoutsetinfo()
        tip = {"height": info["blocks"],
               "best": bytes.fromhex(info["bestblockhash"])[::-1].hex(),
               "muhash": utxo["muhash"]}
        out["tip"] = tip
        checks.update({f"{k} equal": tip[k] == record[k]
                       for k in ("height", "best", "muhash")})
        checks["bestblock equal"] = utxo["bestblock"] == info["bestblockhash"]
        tpu = rpc.gettpuinfo()
        fallbacks = {
            "cpu_fallback_sigs": tpu["batch"]["cpu_fallback_sigs"],
            "fault_fallback_sigs": tpu["batch"]["fault_fallback_sigs"],
            "breaker_fallback_calls": sum(
                b["fallback_calls"] for b in tpu["breakers"].values())}
        dispatched = {k: v["dispatches"] for k, v in
                      tpu["device"]["programs"].items() if v["dispatches"]}
        out.update(devices=tpu["devices"], ecdsa=tpu["ecdsa"]["kernel"],
                   programs=dispatched,
                   batch={k: tpu["batch"][k] for k in (
                       "dispatches", "sigs_verified", "glv_dev_dispatches")
                       if k in tpu["batch"]},
                   fallbacks=fallbacks)
        want_devices = (["cpu"] if device == "cpu" else
                        [torch.cuda.get_device_name(0)])
        # on a CPU device (the rehearsal) "auto" takes the native CPU
        # batch, as the reference does on a CPU backend: no device program
        # runs, and its signatures count as CPU ones
        on_card = device != "cpu"
        checks.update({
            "devices name the card": tpu["devices"] == want_devices,
            "ecdsa glv": tpu["ecdsa"]["kernel"] == "glv",
            "programs dispatched": bool(dispatched) or not on_card,
            "no fallback": not any(fallbacks.values()) or not on_card})
        prof = os.path.join(base, "profile")
        rpc.startprofile(prof)
        height = tip["height"]
        t1 = time.monotonic()
        first = rpc.submitblock(tips[0].hex())
        again = rpc.submitblock(tips[0].hex())
        stayed = rpc.getblockcount() == height
        good = rpc.submitblock(tips[1].hex())
        moved = rpc.getblockcount() == height + 1
        out["submit_s"] = time.monotonic() - t1
        stopped = rpc.stopprofile()
        trace_path = os.path.join(prof, "trace.json")
        with open(trace_path) as f:
            events = json.load(f).get("traceEvents", [])
        cats: dict = {}
        for e in events:
            cat = str(e.get("cat"))
            cats[cat] = cats.get(cat, 0) + 1
        names = sorted({e.get("name", "") for e in events
                        if e.get("cat") == "kernel"})
        port = [k for k in names if re.search(PORT_KERNEL_RE, k)]
        out.update(submit={"tampered": first, "tampered_again": again,
                           "good": good}, profile=stopped,
                   trace_events=len(events), trace_categories=cats,
                   trace_kernels=names[:20],
                   trace_port_kernels=port)
        checks.update({
            "tampered rejected": stayed and again == "duplicate-invalid",
            "good accepted": good is None and moved,
            "trace names a port kernel": bool(port) or not on_card})
        cli = subprocess.run(
            [sys.executable, "-m", "bitcoincashplus_tpu_torch.cli.bcp_cli",
             "-regtest", f"-datadir={base}", f"-rpcport={rpc_port}",
             "getblockcount"], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=timeout)
        checks["bcp_cli getblockcount"] = (
            cli.returncode == 0 and cli.stdout.strip() == str(height + 1))
        t1 = time.monotonic()
        mined = rpc.generatetoaddress(1, rpc.getnewaddress())
        out["generate_s"] = time.monotonic() - t1
        mining = rpc.gettpuinfo()["mining"]
        out["mining_engine"] = mining["engine"]
        checks["generatetoaddress 1"] = (
            len(mined) == 1 and rpc.getblockcount() == height + 2)
        checks["mining engine"] = mining["engine"] == (
            "h7-dispatch" if on_card else "scalar-host")
        tpu = rpc.gettpuinfo()
        out["fallbacks_after"] = {
            "cpu_fallback_sigs": tpu["batch"]["cpu_fallback_sigs"],
            "fault_fallback_sigs": tpu["batch"]["fault_fallback_sigs"],
            "breaker_fallback_calls": sum(
                b["fallback_calls"] for b in tpu["breakers"].values())}
        checks["no fallback after"] = not on_card or not any(
            out["fallbacks_after"].values())
        # the live-traffic path over RPC (phase 5e(c))
        out["storm"] = daemon_storm(rpc, rpc_port, base, timeout)
        checks.update(out["storm"]["checks"])
        rpc.stop()
        rc = proc.wait(timeout)
        out["exit_code"] = rc
        checks["exit 0"] = rc == 0
    except BaseException:
        log(f"bcpd stderr: {tail('stderr')}")
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        for f in logs.values():
            f.close()
        shutil.rmtree(base, ignore_errors=True)
        for k in logs:
            os.remove(f"{base}.{k}")
    out["wall_s"] = time.monotonic() - t0
    out["checks"] = checks
    return out


def shard_phases(clock_hz: float, ops_exact: int) -> tuple:
    """Phases 7a-7c, the sharded paths (K13): one launch a shard at each
    layout of shard_layouts, the host folds (counts zeroed inside, just
    before each call); each phase's wall and results logged, any failed
    check raised. Returns their results."""
    t0 = time.monotonic()
    ss = shard_sig_phase(clock_hz)
    log(f"shard signatures: {json.dumps(ss, sort_keys=True)}")
    for r in ss["runs"]:
        log(f"shard signatures {r['kernel']} {r['layout']} (width "
            f"{r['width']}): {ss['n']} sigs in {r['wall_s']:.3f} s; launches "
            f"{r['launches']}, shapes {r['launch_shapes']}, degenerate "
            f"re-checks {r['degenerate_rechecks']}; fallbacks "
            f"{r['fallbacks']}")
    for name, r in ss["programs"].items():
        log(f"{name} ({r['entry']} a shard, {r['B']} lanes): call wall "
            f"{', '.join(f'{k} {v:.3f}' for k, v in r['ms'].items())} ms; "
            f"plain {r['plain_ms']:.1f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        for lname, p in r["parts"].items():
            log(f"{name} breakdown at {lname} (ms, medians): "
                f"{parts_text(p)}")
    for name, r in ss["four_waves"]["programs"].items():
        log(f"{name} four waves ({ss['four_waves']['n']} sigs, {r['B']} "
            f"lanes): call wall "
            f"{', '.join(f'{k} {v:.3f}' for k, v in r['ms'].items())} ms")
        for lname, p in r["parts"].items():
            log(f"{name} four waves breakdown at {lname} (ms, medians): "
                f"{parts_text(p)}")
    log(f"phase 7a wall {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    sm = shard_msm_phase(clock_hz)
    log(f"shard msm: {json.dumps(sm, sort_keys=True)}")
    r = sm["program"]
    log(f"sharded_msm ({r['terms']} terms, bucket {r['M']} at width 1): "
        f"call wall {', '.join(f'{k} {v:.3f}' for k, v in r['ms'].items())} "
        f"ms; plain {r['plain_ms']:.1f} ms; bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); shards of padding alone {sm['padding']}")
    for lname, p in r["parts"].items():
        log(f"sharded_msm breakdown at {lname} (msm_is_infinity_sharded, "
            f"{r['terms']} terms; ms, medians): {parts_text(p)}")
    w = sm["four_waves"]
    log(f"sharded_msm four waves ({w['terms']} terms, bucket {w['M']}): "
        f"call wall {', '.join(f'{k} {v:.3f}' for k, v in w['ms'].items())}"
        f" ms; bound {w['bound_one_card']['bound_ms']:.4f} ms on one card "
        f"({w['bound_one_card']['bound_by']}), "
        f"{w['bound_each_card']['bound_ms']:.4f} ms with a shard a card")
    for lname, p in w["parts"].items():
        log(f"sharded_msm four waves breakdown at {lname} "
            f"(msm_is_infinity_sharded; ms, medians): {parts_text(p)}")
    log(f"phase 7b wall {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    sn = shard_nonce_phase(clock_hz, ops_exact)
    log(f"shard nonces: {json.dumps(sn, sort_keys=True)}")
    r = sn["program"]
    log(f"sharded_sweep (first hit {r['first_hit']}, header {r['header_tried']}"
        f" tried): call wall "
        f"{', '.join(f'{k} {v:.3f}' for k, v in r['ms'].items())} ms; plain "
        f"{r['plain_ms']:.1f} ms over {r['nonces']} nonces; bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}); blocks {sn['blocks']}")
    log(f"phase 7c wall {time.monotonic() - t0:.1f} s")
    failed = [f"{name}: {k}" for name, ph in (("7a", ss), ("7b", sm),
                                              ("7c", sn))
              for k, v in ph["checks"].items() if not v]
    if failed:
        raise AssertionError(f"sharded path checks failed: {failed}")
    return ss, sm, sn


def shard_kernel_rows(ss: dict, sm: dict, sn: dict) -> list:
    """The report's rows of the sharded programs (K13): the per-shard
    entry's launches on the sharded phases' calls; times at the default
    layout (chip_mesh(): every card), on [cuda:0] * 4 and of the
    unsharded call beside them."""
    import torch

    from bitcoincashplus_tpu_torch.ops import secp256k1 as S

    rows = []
    lay1, lay4 = shard_layouts(torch.device("cuda"))
    for name, r in ss["programs"].items():
        entry = r["entry"]
        source = ("w4_verify.cu" if entry == "w4_verify_bytes" else
                  "glv_pair.cu" if S.launch_shape(r["B"], S.GLV_LAUNCH)[0]
                  > S.GLV_PAIR else "glv_verify.cu")
        launches = sum(x["launches"].get(entry, 0) for x in ss["runs"]) + \
            sum(n for h in [*ss["host_split"].values(), *ss["four_waves"]["runs"]]
                for e, _B, n in h["launch_shapes"] if e == entry)
        rows.append({
            "name": name, "route": "cuda",
            "source": "bitcoincashplus_tpu_torch/csrc/" + source,
            "replaces": r["replaces"], "launches": launches,
            "max_abs_err": 0, "ms": r["ms"][lay1], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "entry": entry, "B": r["B"],
            "ms_4_streams": r["ms"][lay4], "unsharded_ms": r["ms"]["unsharded"],
            "walls": r["ms"], "parts": r["parts"],
            "four_waves": ss["four_waves"]["programs"][name]})
    r = sm["program"]
    rows.append({
        "name": "sharded_msm", "route": "cuda",
        "source": "bitcoincashplus_tpu_torch/csrc/msm.cu",
        "replaces": "bitcoincashplus_tpu/parallel/sig_shard.py:165",
        "launches": sum(n for x in sm["runs"]
                        for _e, _M, n in x["launch_shapes"])
        + sm["four_waves"]["launches"],
        "max_abs_err": 0, "ms": r["ms"][lay1], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None, "entry": "msm_partial", "M": r["M"],
        "ms_4_streams": r["ms"][lay4], "unsharded_ms": r["ms"]["unsharded"],
        "walls": r["ms"], "parts": r["parts"],
        "four_waves": sm["four_waves"]})
    r = sn["program"]
    rows.append({
        "name": "sharded_sweep", "route": "cuda",
        "source": "bitcoincashplus_tpu_torch/csrc/sha256d_sweep.cu",
        "replaces": "bitcoincashplus_tpu/parallel/nonce_shard.py:80",
        "launches": sum(x["launches"]["sweep_exact"] for x in sn["runs"])
        + sum(b["launches"] for b in sn["blocks"].values()),
        "max_abs_err": 0, "ms": r["ms"][f"from 0 {lay1}"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "entry": "sweep_exact", "nonces": r["nonces"],
        "ms_4_streams": r["ms"][f"from 0 {lay4}"],
        "unsharded_ms": r["ms"]["from 0 unsharded"]})
    return rows


def dev_tip(summary: dict) -> bytes:
    return bytes.fromhex(summary["best"])


def main() -> int:
    args = sys.argv[1:]
    if args not in ([], ["--sharded"], ["--msm-teams"]):
        print("usage: chip_smoke.py [--sharded | --msm-teams]",
              file=sys.stderr)
        return 2
    sharded_only = args == ["--sharded"]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from bitcoincashplus_tpu_torch.ops import cuda_build
        from bitcoincashplus_tpu_torch.ops import dispatch as DP
        from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
        from bitcoincashplus_tpu_torch.ops import secp256k1 as S
        from bitcoincashplus_tpu_torch.ops import sha256_sweep as SW
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable ({e})",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules or any(m.startswith("bitcoincashplus_tpu.")
                                   for m in sys.modules):
        print("chip_smoke: the JAX package was imported", file=sys.stderr)
        return 1
    cuda_build.set_device("cuda")
    t_all = time.monotonic()
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    clock_hz = clock_mhz * 1e6
    log(f"card: {card}, max SM clock {clock_mhz:.0f} MHz, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    if args == ["--msm-teams"]:
        rows = msm_team_sweep(clock_hz)
        print(json.dumps({"card": card, "msm_teams": rows}))
        return 0

    # 1. build: each csrc/*.cu by its own nvcc, all started together
    t0 = time.monotonic()
    cuda_build.kernel_libs()
    build_s = time.monotonic() - t0
    info = cuda_build.BUILD_INFO
    log(f"build: {build_s:.1f} s, {len(info['libraries'])} libraries"
        f"{' (cached)' if info['cached'] else ''}")
    ptxas = ptxas_report(info.get("log", ""))
    for fn, r in sorted(ptxas.items()):
        log(f"ptxas: {fn}: {r}")
    sass = {}
    for lib in info["libraries"].values():
        sass.update(sass_counts(lib, W4_KERNELS + GLV_KERNELS
                                + SWEEP_KERNELS + BATCH_KERNELS
                                + MSM_KERNELS + LADDER_KERNELS) or {})
    # the w4 kernels keep every value in registers and shared memory: no
    # stack frame, no spill, no local load or store in their SASS
    w4 = {fn: r for fn, r in ptxas.items() if "w4_" in fn}
    w4_sass = {k: v for k, v in sass.items() if k.startswith(W4_KERNELS)}
    if len(w4) != 2 * len(W4_TEAMS) + 1 or \
            len(w4_sass) != 2 * len(W4_TEAMS) + 1:
        raise AssertionError(f"w4 kernels missing from the build report: "
                             f"ptxas {sorted(w4)}, SASS {sorted(w4_sass)}")
    local = {k: v["local"] for k, v in w4_sass.items()}
    for k, v in sorted(w4_sass.items()):
        log(f"SASS of {k}: {v['total']} instructions, {v['local']} LDL/STL; "
            f"top {v['top']}")
    if any(r["stack"] or r["spill_stores"] or r["spill_loads"]
           for r in w4.values()) or any(local.values()):
        raise AssertionError(f"w4 kernels use local memory: ptxas {w4}, "
                             f"SASS LDL/STL {local}")
    # the GLV kernels: all reported; the pair design's instances gated as
    # the w4 ones (no stack frame, spill or LDL/STL)
    glv_build = {k: {**ptxas.get(k, {}),
                     "sass_total": sass.get(k, {}).get("total"),
                     "ldl_stl": sass.get(k, {}).get("local")}
                 for k in sorted(set(ptxas) | set(sass))
                 if k.startswith(GLV_KERNELS)}
    for k, v in glv_build.items():
        log(f"GLV build: {k}: {v}")
    pair = {k: v for k, v in glv_build.items()
            if k.startswith(GLV_PAIR_KERNELS)}
    n_pair = 2 * sum(t > S.GLV_PAIR for t in S.GLV_TEAMS)
    if len(pair) != n_pair or any(v.get("registers") is None
                                  or v["ldl_stl"] is None for v in
                                  pair.values()):
        raise AssertionError(f"pair-design GLV kernels missing from the "
                             f"build report: {sorted(pair)}")
    if any(v["stack"] or v["spill_stores"] or v["spill_loads"]
           or v["ldl_stl"] for v in pair.values()):
        raise AssertionError(f"pair-design GLV kernels use local memory: "
                             f"{pair}")
    # the sweep bound: ALU-pipe instructions a nonce, counted from the
    # rounds and checked against the kernels' SASS (the lower count holds)
    ops = {}
    for key, kernel in (("h7", "sweep_h7_kernel"),
                        ("exact", "sweep_exact_kernel")):
        count = sweep_ops_per_nonce(key == "exact")
        ops[key] = count["alu"]
        if kernel not in sass:
            log(f"SASS of {kernel}: cuobjdump unavailable; the rounds count "
                f"{count} a nonce")
            continue
        sc = sass[kernel]
        log(f"SASS of {kernel}: {sc['total']} instructions, "
            f"{sc['integer']} integer, {sc['alu']} ALU-pipe only; the "
            f"rounds count {count} a nonce (ALU ratio "
            f"{sc['alu'] / count['alu']:.3f}, integer ratio "
            f"{sc['integer'] / count['total']:.3f}); top {sc['top']}")
        ops[key] = min(ops[key], sc["alu"])
    # the batch kernels: no local memory; SASS beside the counts from the
    # rounds (a header and a pair are one thread's straight-line work)
    batch = {k: {**ptxas.get(k, {}), **{f"sass_{f}": v.get(f) for f, v in
                                        ((f, sass.get(k, {})) for f in
                                         ("total", "alu", "local"))}}
             for k in sorted(set(ptxas) | set(sass))
             if k.startswith(BATCH_KERNELS)}
    for k, v in batch.items():
        log(f"batch build: {k}: {v}")
    if len(batch) != len(BATCH_KERNELS) + 1 or any(
            v.get("registers") is None or v["stack"] or v["spill_stores"]
            or v["spill_loads"] or v["sass_local"] for v in batch.values()):
        raise AssertionError(f"batch kernels missing from the build report "
                             f"or using local memory: {batch}")
    # the bit ladder: registers, stack, spills and SASS local accesses,
    # reported
    for k in sorted(set(ptxas) | set(sass)):
        if k.startswith(LADDER_KERNELS):
            log(f"ladder build: {k}: {ptxas.get(k)}, SASS "
                f"{sass.get(k, {}).get('total')} instructions, "
                f"{sass.get(k, {}).get('local')} LDL/STL")
    if not any(k.startswith(LADDER_KERNELS) for k in ptxas):
        raise AssertionError("the bit ladder is missing from the build "
                             "report")
    # the MSM kernels: registers, stack and spills of every instance, no
    # local memory (the buckets live in global memory by design)
    msm_build = {k: {**ptxas.get(k, {}), "sass_total":
                     sass.get(k, {}).get("total"),
                     "ldl_stl": sass.get(k, {}).get("local")}
                 for k in sorted(set(ptxas) | set(sass))
                 if k.startswith(MSM_KERNELS)}
    for k, v in msm_build.items():
        log(f"MSM build: {k}: {v}")
    # (the walk and the merge have two instances each: teams of 4 and 2)
    if len(msm_build) != len(MSM_KERNELS) + 2 or any(
            v.get("registers") is None or v["stack"] or v["spill_stores"]
            or v["spill_loads"] or v["ldl_stl"] for v in msm_build.values()):
        raise AssertionError(f"MSM kernels missing from the build report or "
                             f"using local memory: {msm_build}")
    bops = batch_ops()
    for key, kernel in (("header", "sha256d_headers_kernel<0>"),
                        ("pair", "sha256d_pairs_kernel")):
        if batch[kernel]["sass_alu"] is not None:
            log(f"SASS of {kernel}: {batch[kernel]['sass_total']} "
                f"instructions, {batch[kernel]['sass_alu']} ALU-pipe only; "
                f"the rounds count {bops[key]} a {key} (ALU ratio "
                f"{batch[kernel]['sass_alu'] / bops[key]['alu']:.3f})")
    # the chain step's census: its loop body is one sha256d_64, 3
    # compressions, beside the count taken from the rounds
    chain_sass = sass.get("sha256d_chain_kernel")
    parts = bops["pair"]["compressions"]
    if chain_sass is not None:
        log(f"SASS of sha256d_chain_kernel: {chain_sass['total']} "
            f"instructions ({chain_sass['alu']} ALU-pipe only), "
            f"{chain_sass['total'] / 3:.0f} a compression; the rounds count "
            f"{' + '.join(map(str, parts))} = {sum(parts)} a sha256d_64, "
            f"{sum(parts) / 3:.0f} a compression; top "
            f"{chain_sass['top']}")
    path_sass = sass.get("sha256_round_path_kernel")
    if path_sass is not None:
        log(f"SASS of sha256_round_path_kernel: {path_sass['total']} "
            f"instructions for its 64 rounds ({path_sass['alu']} ALU-pipe "
            f"only); top {path_sass['top']}")

    if sharded_only:
        # the sharded paths alone, over every card of the host
        ss, sm, sn = shard_phases(clock_hz, ops["exact"])
        log(f"total {time.monotonic() - t_all:.0f} s")
        print(json.dumps({"kernels": shard_kernel_rows(ss, sm, sn)}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # 2. the w4 field core alone, then the ECDSA kernels at every shape,
    # team size and block size
    selftest = field_selftest()
    log(f"w4_field_selftest: {json.dumps(selftest)}")
    chains = field_chains(clock_hz)
    log(f"field chains: {json.dumps(chains)}")
    seeds = {"w4_verify_bytes": 100, "w4_verify_planes": 200,
             "glv_dev_verify": 600, "glv_verify": 700}
    case_fn = {name: glv_case if name.startswith("glv") else kernel_case
               for name in seeds}
    cases = {name: [case_fn[name](name, B, seeds[name] + i, clock_hz)
                    for i, B in enumerate(GLV_SHAPES if name.startswith("glv")
                                          else W4_SHAPES)]
             for name in seeds}
    # 2b. the GLV split alone, through its own entry point
    decomp = glv_decompose_phase(clock_hz)
    log(f"glv_decompose: {json.dumps(decomp)}; every lane equal to the "
        f"Python split and to the plain version")
    log(f"glv_decompose wrapper at {decomp['B']} scalars: {decomp['ms']:.4f} "
        f"ms a call by events around 20 calls; its parts "
        f"{json.dumps(decomp['parts'])}")
    # 2c. the Schnorr MSM (K9) at every bucket, against its plain version
    # and the host's sum
    fe_cycles = chains["cycles_a_step"]["fe_mul 1 warp(s)/scheduler"]
    msm_rows = [msm_case(M, 700 + i, clock_hz, fe_cycles)
                for i, M in enumerate(MSM_BUCKETS)]
    for r in msm_rows:
        w, old = r["work"], r["work"]["horner"]
        log(f"msm M={r['M']} (K={r['K']}): msm_run {r['ms']:.4f} ms (launch "
            f"kinds {', '.join(f'{k} {v:.4f}' for k, v in r['stages'].items())} ms), "
            f"plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; the fewer of this schedule's "
            f"{r['bound_ms_split']:.4f} ms: {w['madd']} mixed adds, "
            f"{w['full']} full adds, {w['double']} doublings, and the "
            f"Horner schedule's {r['bound_ms_horner']:.4f} ms: "
            f"{old['madd']}, {old['full']}, {old['double']}), chain floor {r['chain_floor_ms']:.4f} ms "
            f"({w['chain_levels']} dependent product levels x "
            f"{fe_cycles:.0f} cycles; the Horner schedule "
            f"{old['chain_levels']} levels, "
            f"{r['chain_floor_ms_horner']:.4f} ms); {r['cases']} "
            f"results equal to the plain version and the host's sum; the "
            f"crafted tree corpus's special cases {r['tree_tally']}")
    # 2d. the bit ladder (K8) at every plane bucket, against its plain
    # version and the oracle
    ladder_rows = [ladder_case(B, 950 + i, clock_hz, fe_cycles)
                   for i, B in enumerate(LADDER_SHAPES)]
    for r in ladder_rows:
        log(f"ladder_verify B={r['B']}: kernel {r['ms']:.3f} ms "
            f"({r['sigs_per_s']:.0f} sigs/s), plain {r['plain_ms']:.1f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {r['imads']} "
            f"IMADs; {r['bytes_in']} bytes in; the bit ladder "
            f"{r['bound_ms_bits']:.4f} ms, {r['imads_bits']} IMADs), chain "
            f"floor {r['chain_floor_ms']:.4f} ms ({r['chain_levels']} "
            f"levels; the bit ladder's {r['chain_levels_bits']} levels, "
            f"{r['chain_floor_ms_bits']:.4f} ms), {r['valid']} valid lanes; "
            f"equal to the plain version lane for lane and to the oracle")
    log(f"GLV_LAUNCH (most lanes, team code, block): {S.GLV_LAUNCH}; team "
        f"codes {S.GLV_TEAMS} ({', '.join(map(team_name, S.GLV_TEAMS))})")
    for name, rows in cases.items():
        glv = name.startswith("glv")
        for r in rows:
            fastest = min(r["times"], key=r["times"].get)
            for team in (S.GLV_TEAMS if glv else W4_TEAMS):
                at = ", ".join(f"block {b} {r['times'][f'{team}x{b}']:.3f} ms"
                               for b in W4_BLOCKS)
                label = team_name(team) if glv else f"T={team}"
                log(f"{name} B={r['B']} {label}: {at}; equal to the plain "
                    f"version and the oracle")
            log(f"{name} B={r['B']}: the table's launch team x block = "
                f"{r['shape'][0]}x{r['shape'][1]} at {r['ms']:.3f} ms, "
                f"fastest measured {fastest} at "
                f"{r['times'][fastest]:.3f} ms; bound {r['bound_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.1f} ms, {r['degen_lanes']} degen "
                f"lane(s), err {r['max_abs_err']}")
            if glv:
                c = r["chain_shape"]
                log(f"{name} B={r['B']}: the table's launch {r['ms']:.3f} ms "
                    f"against the carry-chain design at w4's T x block = "
                    f"{c[0]}x{c[1]} {r['chain_ms']:.3f} ms in this call "
                    f"({r['chain_ms'] / r['ms']:.2f}x); "
                    f"{r['warps_per_scheduler']:.2f} warps a scheduler")

    # 3. the sweep kernels against their plain versions
    sweeps = {name: [sweep_case(name, tile, n, 300 + 10 * i + j, clock_hz,
                                ops)
                     for j, (tile, n) in enumerate(cfgs)]
              for i, (name, cfgs) in enumerate(SWEEP_CONFIGS.items())}
    # the exact and h7 engines' whole-space launch: compared with a hit
    # far into it, and timed without one
    engine_tiles = (("sweep_h7", 1 << 20), ("sweep_exact", 1 << 16))
    whole = {name: whole_space_case(name, tile, clock_hz, ops)
             for name, tile in engine_tiles}
    full = {name: full_launch(name, tile, clock_hz, ops)
            for name, tile in engine_tiles}
    for name, r in whole.items():
        log(f"{name} tile={r['tile']} x {r['n_tiles']} from 0, first hit "
            f"{r['result']}: kernel {r['ms']:.3f} ms = {r['ghs']:.3f} GH/s "
            f"over {r['nonces']} nonces, plain {r['plain_ms']:.1f} ms, "
            f"bound {r['bound_ms']:.3f} ms, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound; equal")
    for name, r in full.items():
        log(f"{name} tile={r['tile']} x {r['n_tiles']} (2^32 nonces, no "
            f"hit): kernel {r['ms']:.1f} ms = {r['ghs']:.3f} GH/s, bound "
            f"{r['bound_ms']:.1f} ms, {100 * r['bound_ms'] / r['ms']:.1f}% "
            f"of the bound")
    for name, rows in sweeps.items():
        for r in rows:
            log(f"{name} tile={r['tile']} x {r['n_tiles']}: kernel "
                f"{r['ms']:.3f} ms = {r['ghs']:.3f} GH/s, plain "
                f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['ops_per_nonce']} ops a nonce), "
                f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound; "
                f"{r['settings']} settings equal, {r['found']} of "
                f"{SWEEP_STARTS} starts hit, straddle {r['straddle']}")

    # 3b. the batch SHA-256d kernels against their plain versions
    chain = hash_chain(clock_hz)
    log(f"sha256d_chain: one dependent sha256d_64 (3 compressions) "
        f"{chain['step_ms'] * 1e3:.3f} us = {chain['cycles_a_step']:.0f} "
        f"cycles; equal to hashlib's chain")
    path = round_path(clock_hz)
    log(f"sha256_round_path: one round's e -> e' path "
        f"{path['round_ms'] * 1e6:.3f} ns = {path['cycles_a_round']:.2f} "
        f"cycles, {192 * path['round_ms'] * 1e3:.3f} us for the 192 rounds "
        f"of a sha256d; equal to its model")
    step, rnd = chain["step_ms"], path["round_ms"]
    hdr_rows = [header_case(B, 400 + i, clock_hz, bops, step, rnd)
                for i, B in enumerate(HEADER_SHAPES)]
    tree_rows = [tree_case(b, 500 + i, clock_hz, bops, step, rnd)
                 for i, b in enumerate(TREE_BUCKETS)]
    pair_rows = [pairs_case(n, 600 + i, clock_hz, bops, step, rnd)
                 for i, n in enumerate(PAIR_SHAPES)]

    def bound_text(r):
        return (f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
                f"{r['bound_of']}; the card {r['card_bound_ms']:.5f}, the "
                f"dependent path {r['path_bound_ms']:.5f}), this design's "
                f"issue floor {r['issue_floor_ms']:.5f}")

    for r in hdr_rows:
        log(f"sha256d_headers B={r['B']}: kernel {r['ms']:.4f} ms (the "
            f"wrapper {r['wrapper_ms']:.4f} ms a call), plain "
            f"{r['plain_ms']:.1f} ms, {bound_text(r)}, chain floor "
            f"{r['chain_floor_ms']:.4f} ms; check_headers_pow "
            f"{r['pow_ms']:.4f} ms, plain {r['pow_plain_ms']:.1f} ms, "
            f"{bound_text(r['pow_bound'])}; equal to the plain versions, "
            f"hashlib and the compare")
    for r in tree_rows:
        log(f"merkle_tree bucket={r['bucket']} (launches "
            f"{r['launch_plan']}): kernel {r['ms']:.4f} ms at m = bucket "
            f"({r['zeroed_ms']:.4f} ms with the ticket counter zeroed "
            f"before each call; the wrapper {r['wrapper_ms']:.4f} ms a "
            f"call, compute_merkle_root_tpu_ex {r['host_api_ms']:.4f} ms), "
            f"plain {r['plain_ms']:.1f} ms, {bound_text(r)}, "
            f"{r['pair_hashes']} pair hashes, chain floor "
            f"{r['chain_floor_ms']:.4f} ms ({r['chain_steps']} dependent "
            f"hashes); cases {r['cases']} equal to the plain version and "
            f"the host oracles")
    for r in pair_rows:
        log(f"sha256d_pairs N={r['N']}: kernel {r['ms']:.4f} ms (the "
            f"wrapper {r['wrapper_ms']:.4f} ms a call), plain "
            f"{r['plain_ms']:.1f} ms, {bound_text(r)}; equal to the plain "
            f"version and hashlib")

    # 4. a known answer: the mainnet genesis window
    gen = genesis_phase()
    log(f"genesis: {json.dumps(gen, sort_keys=True)}")

    # 5. the block-validation slice (ECDSA main path; counts zeroed inside)
    workdir = os.path.join(REPO, "build", "smoke_chain")
    shutil.rmtree(workdir, ignore_errors=True)
    sl = slice_phase(workdir)
    tips = sl.pop("tips")
    # 5d. the node's -reindex of the same chain (fresh copies beside it);
    # a copy is kept for the daemon (phase 8)
    ddir = os.path.join(REPO, "build", "smoke_daemon_chain")
    shutil.rmtree(ddir, ignore_errors=True)
    try:
        nd = node_phase(workdir, sl["gen"]["sigs"])
        shutil.copytree(workdir, ddir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # 5e. the live-traffic path: mempool admission through the signature
    # service (counts zeroed inside, just before each run; results below)
    sdir = os.path.join(REPO, "build", "smoke_serving")
    shutil.rmtree(sdir, ignore_errors=True)
    try:
        sv = serving_phase(sdir)
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    log(f"slice: {json.dumps(sl, sort_keys=True)}")
    failed = []
    for i, run in enumerate(sl["runs"]):
        kern, st = run["kernel"], run["stats"]
        log(f"slice run {i} ({kern}): {run['sigs']} sigs in "
            f"{run['wall_s']:.3f} s = {run['sigs_per_s']:.0f} sigs/s; "
            f"blocking settle wait (E.STATS.device_seconds) "
            f"{st['device_seconds']:.4f} s = "
            f"{100 * st['device_seconds'] / run['wall_s']:.2f}% of the "
            f"wall; GLV emit {st['glv_emit_s']:.4f} s, enqueue "
            f"{st['glv_dispatch_s']:.4f} s; launches {run['launches']}")
        failed += [f"run {i} ({kern}): {k}"
                   for k, v in run["checks"].items() if not v]
    drills = sl["drills"]
    for site in (E.GLV_DEV_SITE, E.GLV_SITE):
        log(f"drill {site}: {drills[site]['launches']}")
        failed += [f"drill {site}: {k}"
                   for k, v in drills[site]["checks"].items() if not v]
    if not drills["verdicts_equal"]:
        failed.append("drills: verdicts differ")
    if failed:
        raise AssertionError(f"slice checks failed: {failed}")
    # every shape a path launched is held against the plain version; the
    # launches of an entry are summed over the paths that ran it (both
    # validation runs, the drills, the decompose surface)
    path_shapes = {name: {} for name in S.LAUNCHES}
    path_launches = {name: 0 for name in S.LAUNCHES}
    path_launches["glv_decompose"] = decomp["launches"]
    for run in sl["runs"] + [drills[E.GLV_DEV_SITE], drills[E.GLV_SITE]]:
        for name, n in run["launches"].items():
            path_launches[name] += n
        for name, B, count in run["launch_shapes"]:
            path_shapes[name][B] = path_shapes[name].get(B, 0) + count
    # the serving path's launches (phase 5e: the levels and the node)
    for run in [row["serviced"] for row in sv["levels"]] + [
            sv["node"]["runs"]["serviced"]]:
        for name, B, count in run["launch_shapes"]:
            path_launches[name] += count
            path_shapes[name][B] = path_shapes[name].get(B, 0) + count
    for name, shapes in path_shapes.items():
        for B in shapes:
            if name in cases and all(r["B"] != B for r in cases[name]):
                cases[name].append(case_fn[name](
                    name, B, seeds[name] + len(cases[name]), clock_hz))
    for name, rows in cases.items():
        rows.sort(key=lambda r: r["B"])
        for r in rows:
            log(f"{name} B={r['B']}: kernel {r['ms']:.3f} ms (T x block "
                f"{r['shape'][0]}x{r['shape'][1]}), plain "
                f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), {r['sigs_per_s']:.0f} sigs/s, "
                f"{r['degen_lanes']} degen lane(s), err {r['max_abs_err']}, "
                f"{path_shapes[name].get(r['B'], 0)} main-path launch(es)")

    log(f"node -reindex: {json.dumps(nd, sort_keys=True)}")
    for name, run in nd["runs"].items():
        log(f"node -reindex {name} ({run['flags']}): "
            f"height {run['height']}, {run['wall_s']:.3f} s = "
            f"{run['sigs_per_s']:.0f} sigs/s, engine {run['engine']}, "
            f"muhash {run['muhash'][:16]}; launches "
            f"{ {k: v for k, v in run['launches'].items() if v} }, shapes "
            f"{run['launch_shapes']}; fallbacks {run['fallbacks']}")
    failed = [k for k, v in nd["checks"].items() if not v]
    if failed:
        raise AssertionError(f"node -reindex checks failed: {failed}")

    # 5e. the live-traffic path (run after phase 5d, above): its results
    serving_report(sv, cases, msm_rows)

    # 5b. the validation path with big blocks (the device Merkle leg)
    bdir = os.path.join(REPO, "build", "smoke_bigchain")
    shutil.rmtree(bdir, ignore_errors=True)
    try:
        bb = bigblock_phase(bdir)
    finally:
        shutil.rmtree(bdir, ignore_errors=True)
    log(f"big blocks: {json.dumps(bb, sort_keys=True)}")
    log(f"big blocks: {bb['sigs']} sigs, {bb['blocks']} blocks in "
        f"{bb['wall_s']:.3f} s on the device path (CPU engine "
        f"{bb['cpu_wall_s']:.3f} s); the Merkle leg of the blocks of "
        f"{bb['big_leaves']} leaves "
        f"{[round(t * 1e3, 3) for t in bb['merkle_leg_s']]} ms "
        f"(after the run, the card idle: the leg alone "
        f"{[round(t * 1e3, 3) for t in bb['leg_alone_s']]} ms, the host "
        f"compute_merkle_root "
        f"{[round(t * 1e3, 3) for t in bb['host_merkle_s']]} ms) = "
        f"{100 * bb['merkle_leg_share']:.3f}% of the wall; launches "
        f"{bb['launches']}; crafted {bb['crafted']}")
    if not all(bb["checks"].values()):
        raise AssertionError(f"big-block checks failed: {bb['checks']}")

    # 5c. the Schnorr batch check's paths: dispatch_batch under
    # -ecdsakernel=msm at MSM_CURVE sizes with a forged lane and the
    # drills, then the Schnorr chain (counts zeroed inside, just before
    # each run, read just after)
    from bitcoincashplus_tpu_torch.workload import sigchain
    signers = [sigchain.SchnorrSigner(0x5C4 + k) for k in range(4)]
    md = msm_dispatch_phase(signers)
    log(f"msm dispatch: {json.dumps(md, sort_keys=True)}")
    failed = []
    for key, row in md.items():
        failed += [f"msm dispatch {key}: {k}"
                   for k, v in row["checks"].items() if not v]
        st = row["stats"]
        if "sigs_per_s" in row:
            log(f"msm dispatch {key}: {row['sigs_per_s']:.0f} sigs/s "
                f"({row['wall_s']:.4f} s: the prechecks alone "
                f"{row['precheck_s']:.4f} s, checks' host "
                f"{st['msm_host_s']:.4f} s, "
                f"kernel calls {st['msm_device_s']:.4f} s, canaries "
                f"{st['msm_canary_s']:.4f} s; {st['msm_dispatches']} MSM "
                f"launches, shapes {row['launch_shapes']})"
                + (f"; the per-lane oracle {row['oracle_sigs_per_s']:.1f} "
                   f"sigs/s" if "oracle_sigs_per_s" in row else ""))
    f = md["forged"]["stats"]
    log(f"msm forged lane {md['forged']['position']} of "
        f"{md['forged']['n']}: {md['forged']['wall_s']:.3f} s, "
        f"bisects {f['msm_bisects']}, depth {f['msm_bisect_depth_max']}, "
        f"rejected {f['msm_batches_rejected']}, accepted "
        f"{f['msm_batches_accepted']}, oracle sigs {f['schnorr_cpu_sigs']}")
    mdir = os.path.join(REPO, "build", "smoke_schnorr")
    shutil.rmtree(mdir, ignore_errors=True)
    try:
        mc = msm_chain_phase(mdir, signers)
    finally:
        shutil.rmtree(mdir, ignore_errors=True)
    log(f"schnorr chain: {json.dumps(mc, sort_keys=True)}")
    log(f"schnorr chain: the host prechecks of its {mc['schnorr_lanes']} "
        f"Schnorr lanes alone {mc['precheck_s']:.3f} s; the per-lane oracle "
        f"{mc['oracle']['sigs_per_s']:.1f} sigs/s on {mc['oracle']['lanes']} "
        f"of them, all valid")
    for i, run in enumerate(mc["runs"]):
        st = run["stats"]
        log(f"schnorr chain run {i} (msm): {mc['gen']['sigs']} Schnorr sigs "
            f"in {run['wall_s']:.3f} s = {run['sigs_per_s']:.0f} sigs/s; "
            f"MSM host {st['msm_host_s']:.3f} s, kernel calls "
            f"{st['msm_device_s']:.3f} s, canaries {st['msm_canary_s']:.3f} "
            f"s; launches {run['launches']}, shapes {run['launch_shapes']}")
        failed += [f"schnorr chain run {i}: {k}"
                   for k, v in run["checks"].items() if not v]
    if not mc["oracle"]["all_true"]:
        failed.append("schnorr chain: a sampled lane fails the oracle")
    if failed:
        raise AssertionError(f"msm checks failed: {failed}")

    # 6. the mining slice (the sweeps' main path; counts zeroed inside,
    # just before each engine, read just after)
    mdir = os.path.join(REPO, "build", "smoke_mining")
    shutil.rmtree(mdir, ignore_errors=True)
    try:
        mine = mining_phase(mdir)
    finally:
        shutil.rmtree(mdir, ignore_errors=True)
    # each engine's kernel rate at its own launch shape: the exact and h7
    # engines launch the whole nonce space, pallas-h7 its 2^25-nonce grid,
    # resident-h7 its 2^19-nonce segments
    rate = {"exact": full["sweep_exact"]["ghs"], "h7": full["sweep_h7"]["ghs"],
            "pallas-h7": sweeps["sweep_h7_pallas"][0]["ghs"],
            "resident-h7": next(r["ghs"] for r in sweeps["sweep_h7"]
                                if r["tile"] == 1 << 16)}
    sweep_launches = {name: 0 for name in SW.LAUNCHES}
    for eng, r in mine["engines"].items():
        for name, n in r["launches"].items():
            sweep_launches[name] += n
        ghs = rate[eng]
        kernel_s = r["hashes"] / (ghs * 1e9)
        r["kernel_share"] = kernel_s / r["wall_s"]
        log(f"mining {eng}: {r['blocks']} block(s) at bits {r['bits']}, "
            f"{r['hashes']} hashes swept in {r['wall_s']:.2f} s = "
            f"{r['ghs']:.3f} GH/s end to end; kernel ~{kernel_s:.2f} s = "
            f"{100 * kernel_s / r['wall_s']:.0f}% of the wall (hashes over "
            f"the measured {ghs:.3f} GH/s); launches {r['launches']}")
    log(f"mining: tip height {mine['height']}, miner fallbacks "
        f"{mine['fallbacks']}, resident {json.dumps(mine['resident'])}")
    checks = {
        "connected": all(r["connected"] for r in mine["engines"].values()),
        "difficulty_1": all(r["bits"] == [f"{DIFF1_BITS:#010x}"]
                            for r in mine["engines"].values()),
        "no_fallback": mine["fallbacks"] == 0,
        "entry_launched": all(r["launches"][r["entry"]] > 0
                              for r in mine["engines"].values()),
        "every_sweep_entry": all(n > 0 for n in sweep_launches.values()),
    }
    if not all(checks.values()):
        raise AssertionError(f"mining checks failed: {checks}")

    # 6b. header PoW batches and the certificate MMR (counts zeroed
    # inside); 6c. the host Merkle root beside the device leg
    hp = headers_phase(mine["headers"])
    log(f"headers: {json.dumps(hp, sort_keys=True)}")
    if not all(hp["checks"].values()):
        raise AssertionError(f"header checks failed: {hp['checks']}")
    gate = merkle_gate_phase()
    for n, row in gate.items():
        log(f"merkle root of {n} leaves end to end: host "
            f"{row['host_ms']:.3f} ms, device leg {row['device_ms']:.3f} ms "
            f"(the gate sends {DP._merkle_device_min()} leaves or more to "
            f"the device)")

    # 7a-7c. the sharded paths (K13)
    ss, sm, sn = shard_phases(clock_hz, ops["exact"])

    # 8. the daemon: bcpd -regtest -reindex on the node phase's chain, over
    # RPC
    try:
        dm = daemon_phase(ddir, tips, nd["runs"]["tpu0"])
    finally:
        shutil.rmtree(ddir, ignore_errors=True)
    log(f"daemon: {json.dumps(dm, sort_keys=True)}")
    log(f"daemon: started in {dm['started_s']:.1f} s ({dm['started_line']}), "
        f"tip {dm['tip']['height']}, devices {dm['devices']}, ecdsa "
        f"{dm['ecdsa']}, submit {dm['submit']} in {dm['submit_s']:.3f} s, "
        f"trace port kernels {dm['trace_port_kernels']}, generatetoaddress "
        f"({dm['mining_engine']}) {dm['generate_s']:.3f} s, exit "
        f"{dm['exit_code']}; fallbacks {dm['fallbacks']}; phase 8 wall "
        f"{dm['wall_s']:.1f} s")
    failed = [k for k, v in dm["checks"].items() if not v]
    if failed:
        raise AssertionError(f"daemon checks failed: {failed}")

    # 9. report: each kernel at the shape the main path launched most
    replaces = {
        "w4_verify_bytes": "bitcoincashplus_tpu/ops/secp256k1.py:912",
        "w4_verify_planes": "bitcoincashplus_tpu/ops/secp256k1.py:827",
        "sweep_h7": "bitcoincashplus_tpu/ops/sha256_sweep.py:330",
        "sweep_h7_pallas": "bitcoincashplus_tpu/ops/pallas_sweep.py:100",
        "sweep_exact": "bitcoincashplus_tpu/ops/miner.py:69",
        "glv_dev_verify": "bitcoincashplus_tpu/ops/secp256k1.py:1559",
        "glv_verify": "bitcoincashplus_tpu/ops/secp256k1.py:1296",
        "glv_decompose": "bitcoincashplus_tpu/ops/secp256k1.py:1539",
    }
    msm_replaces = {"msm": "bitcoincashplus_tpu/ops/secp256k1.py:1967",
                    "msm_partial": "bitcoincashplus_tpu/ops/secp256k1.py:1977"}
    kernels = []
    for name, rows in cases.items():
        counts = path_shapes[name]
        top = max(counts, key=lambda b: (counts[b], b))
        row = next(r for r in rows if r["B"] == top)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "bitcoincashplus_tpu_torch/csrc/" + (
                "w4_verify.cu" if not name.startswith("glv") else
                "glv_pair.cu" if row["shape"][0] > S.GLV_PAIR else
                "glv_verify.cu"),
            "replaces": replaces[name],
            "launches": path_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "B": row["B"],
            "team": row["shape"][0], "block": row["shape"][1],
            "shapes": [{**{k: r[k] for k in ("B", "ms", "plain_ms",
                                             "bound_ms", "sigs_per_s",
                                             "shape", "times", "chain_shape",
                                             "chain_ms", "warps_per_scheduler")
                           if k in r},
                        "launches": counts.get(r["B"], 0)} for r in rows],
        })
    kernels.append({
        "name": "glv_decompose", "route": "cuda",
        "source": "bitcoincashplus_tpu_torch/csrc/glv_verify.cu",
        "replaces": replaces["glv_decompose"],
        "launches": path_launches["glv_decompose"],
        **{k: decomp[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "B", "parts")},
        "library_ms": None})
    # each sweep entry at a compared launch shape of the main path:
    # sweep_h7 at the resident segment (its most launched), pallas at its
    # grid, sweep_exact at the exact engine's whole-space launch
    headline = {"sweep_h7": next(r for r in sweeps["sweep_h7"]
                                 if r["tile"] == 1 << 16),
                "sweep_h7_pallas": sweeps["sweep_h7_pallas"][0],
                "sweep_exact": whole["sweep_exact"]}
    for name, rows in sweeps.items():
        row = headline[name]
        compared = rows + ([whole[name]] if name in whole else [])
        shapes_rows = compared + ([full[name]] if name in full else [])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "bitcoincashplus_tpu_torch/csrc/sha256d_sweep.cu",
            "replaces": replaces[name], "launches": sweep_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in compared),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "tile": row["tile"],
            "n_tiles": row["n_tiles"], "nonces": row["nonces"],
            "shapes": [{k: r[k] for k in ("tile", "n_tiles", "nonces", "ms",
                                          "plain_ms", "bound_ms", "ghs")}
                       for r in shapes_rows],
        })
    # the batch kernels: launches on their paths (the header batches, the
    # big-block validation and its crafted blocks, the certificate MMR);
    # check_headers_pow is on none (check_headers_pow_batch compares each
    # digest on the host)
    batch_src = "bitcoincashplus_tpu_torch/csrc/sha256d_batch.cu"
    hdr_main = next(r for r in hdr_rows if r["B"] == 2048)
    tree_main = next(r for r in tree_rows if r["bucket"] == 4096)
    pair_main = next(r for r in pair_rows if r["N"] == 512)
    batch_entries = (
        ("sha256d_headers", "bitcoincashplus_tpu/ops/sha256.py:293",
         sum(r["sha256d_headers"] for r in hp["runs"].values()), hdr_main,
         hdr_rows, {"ms": "ms", "plain_ms": "plain_ms"}),
        ("check_headers_pow", "bitcoincashplus_tpu/ops/sha256.py:300", 0,
         {**hdr_main, **hdr_main["pow_bound"]}, hdr_rows,
         {"ms": "pow_ms", "plain_ms": "pow_plain_ms"}),
        ("merkle_tree", "bitcoincashplus_tpu/ops/merkle.py:46",
         bb["launches"]["merkle_tree"] + sum(
             c["merkle_tree"] for c in bb["crafted"].values()), tree_main,
         tree_rows, {"ms": "ms", "plain_ms": "plain_ms"}),
        ("sha256d_pairs", "bitcoincashplus_tpu/ops/merkle.py:90",
         hp["certificate"]["sha256d_pairs"], pair_main, pair_rows,
         {"ms": "ms", "plain_ms": "plain_ms"}),
    )
    for name, where, launches, row, rows, keys in batch_entries:
        kernels.append({
            "name": name, "route": "cuda", "source": batch_src,
            "replaces": where, "launches": launches, "max_abs_err": 0,
            "ms": row[keys["ms"]], "plain_ms": row[keys["plain_ms"]],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "bound_of": row["bound_of"],
            "chain_floor_ms": row["chain_floor_ms"],
            "shapes": [{k: r[k] for k in ("B", "bucket", "N", "ms",
                                          "pow_ms", "wrapper_ms", "zeroed_ms",
                                          "host_api_ms", "plain_ms",
                                          "bound_ms", "bound_of",
                                          "card_bound_ms", "path_bound_ms",
                                          "issue_floor_ms",
                                          "chain_floor_ms", "launch_plan")
                        if k in r}
                       for r in rows]})
    # the MSM: the verdict entry's launches on its paths (the Schnorr
    # chain's runs, the dispatch sizes, the drills), the partial entry's
    # on the sharded MSM's calls (phase 7b); each at the chain's bucket
    msm_launches = sum(run["launches"]["msm"] for run in mc["runs"]) + sum(
        row["launches"]["msm"] for row in md.values()) + sum(
        row["serviced"]["launches"].get("msm", 0) for row in sv["levels"])
    msm_main = next(r for r in msm_rows if r["M"] == 4096)
    partial_launches = sum(n for x in sm["runs"]
                           for _e, _M, n in x["launch_shapes"])
    for name, launches in (("msm", msm_launches),
                           ("msm_partial", partial_launches)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "bitcoincashplus_tpu_torch/csrc/msm.cu",
            "replaces": msm_replaces[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in msm_rows),
            "ms": msm_main["ms"], "plain_ms": msm_main["plain_ms"],
            "bound_ms": msm_main["bound_ms"],
            "bound_by": msm_main["bound_by"], "library_ms": None,
            "M": 4096, "chain_floor_ms": msm_main["chain_floor_ms"],
            "kernels": list(MSM_KERNELS),
            "shapes": [{k: r[k] for k in ("M", "K", "ms", "stages",
                                          "plain_ms", "bound_ms",
                                          "bound_ms_split", "bound_ms_horner",
                                          "chain_floor_ms",
                                          "chain_floor_ms_horner", "work")}
                       for r in msm_rows]})
    # the bit ladder: its launches on the node's -reindex under
    # BCP_SECP_PALLAS=0, at the shape that run launched most
    ladder_counts = {}
    for _name, B, n in nd["runs"]["ladder"]["launch_shapes"]:
        ladder_counts[B] = ladder_counts.get(B, 0) + n
    top = max(ladder_counts, key=lambda b: (ladder_counts[b], b))
    ladder_main = next(r for r in ladder_rows if r["B"] == top)
    kernels.append({
        "name": "ladder_verify", "route": "cuda",
        "source": "bitcoincashplus_tpu_torch/csrc/ladder_verify.cu",
        "replaces": "bitcoincashplus_tpu/ops/secp256k1.py:509",
        "launches": sum(r["launches"]["ladder_verify"]
                        for r in nd["runs"].values()),
        "max_abs_err": max(r["max_abs_err"] for r in ladder_rows),
        **{k: ladder_main[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "B")},
        "library_ms": None,
        "chain_floor_ms": ladder_main["chain_floor_ms"],
        "shapes": [{**{k: r[k] for k in (
            "B", "ms", "plain_ms", "bound_ms", "bound_ms_bits", "imads",
            "imads_bits", "chain_levels", "chain_levels_bits",
            "chain_floor_ms", "chain_floor_ms_bits", "bytes_in",
            "sigs_per_s")},
                    "launches": ladder_counts.get(r["B"], 0)}
                   for r in ladder_rows]})
    kernels += shard_kernel_rows(ss, sm, sn)
    for kern in sorted(set(PATH_ORDER)):
        walls = [run["wall_s"] for run in sl["runs"]
                 if run["kernel"] == kern]
        log(f"validation ({kern}): {sl['runs'][0]['sigs']} sigs, walls in "
            f"run order {[round(w, 4) for w in walls]} s, median "
            f"{statistics.median(walls):.4f} s on the device path "
            f"(pipeline depth {PIPELINE_DEPTH})")
    log(f"total {time.monotonic() - t_all:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
