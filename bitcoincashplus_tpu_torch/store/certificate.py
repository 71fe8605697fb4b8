"""Proof-carrying snapshot certificates (ISSUE 17).

PR 12's ``-assumeutxo`` made an operator-supplied digest the single
trust anchor of snapshot onboarding, and PR 16 multiplied the blast
radius: one forged snapshot poisons every replica bootstrapped from it,
undetected until hours of shadow re-validation complete. Following
PAPERS.md 2407.03511 (scalable proofs for verifying cryptographic
hashing in blockchain) this module ships each snapshot with a succinct,
recursively-committed SHA-256 certificate — no SNARK — binding three
things together:

  (a) a Merkle-mountain-range commitment over the header chain
      genesis..H (leaf = block hash; peaks follow the pow2 decomposition
      of the leaf count; the root bags peaks right-to-left). Levels are
      hashed lane-parallel on the batched SHA-256 tree machinery
      (ops/merkle.sha256d_pairs), so verification is a handful of
      batched tree recomputations;
  (b) a per-epoch MuHash3072 digest trajectory: the UTXO-set digest
      after block E, 2E, ... and finally H. The dumping validator
      rebuilds it EXACTLY from its undo data by walking blocks tip->1
      and dividing out each block's delta (the accumulator group is
      abelian — one modular inverse per checkpoint, not per block);
  (c) a commitment chain c_0 = H(tag || mmr_root || H || E),
      c_i = H(c_{i-1} || height_i || digest_i) sealing the trajectory
      order and binding it to the header commitment; the final link
      covers the snapshot's set digest itself.

Verification at load (seconds, before a single row is served): recompute
the MMR root from the snapshot's own PoW-checked headers, recompute the
commitment chain, and require the final trajectory digest to equal the
manifest digest the row stream is checked against. A wrong MMR root,
truncated trajectory, or bit-flipped certificate is rejected outright —
the wipe-and-reject path, same as a wrong set digest today. A forged
EPOCH (internally consistent certificate, wrong history) survives load
but is caught by the background shadow validator at the first divergent
epoch checkpoint — O(E) blocks instead of O(H) — which hard-aborts
immediately. ``sample_epochs`` powers ``-snapshotspotcheck=K``: a seeded
draw of K certificate-committed epochs that get full script
re-validation while the rest replay cheaply, turning replica onboarding
from hours into minutes.

The ``snapshot_cert`` fault site (util/faults, explicit-only) arms both
legs: fail-* at verify proves wipe-and-reject, poison-output at build
forges one mid-trajectory epoch digest before the chain is sealed.

stdlib + the batched hashing helper only — importable from jax-free
contexts (sha256d_pairs lazily imports the device path and degrades to
the host loop).
"""

from __future__ import annotations

import hashlib
import random
import struct
from typing import Iterable, Optional

from ..util.faults import INJECTOR, SNAPSHOT_CERT_SITE
from ..util.log import log_printf
from . import muhash

CERT_VERSION = 1
CERT_NAME = "CERTIFICATE.json"
DEFAULT_EPOCH_BLOCKS = 64
_CHAIN_TAG = b"BCP-SNAPCERT-v1"


class CertificateError(Exception):
    """A snapshot certificate that failed structural verification."""


def _sha256d(b: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(b).digest()).digest()


def _hash_level(pairs: list[bytes]) -> list[bytes]:
    """One MMR level: sha256d over 64-byte concatenations, batched on the
    device when the level is wide enough to pay for the trip."""
    try:
        from ..ops.merkle import sha256d_pairs
        return sha256d_pairs(pairs)
    except ImportError:  # pragma: no cover - jax-free caller
        return [_sha256d(p) for p in pairs]


# -- Merkle mountain range --------------------------------------------------

def mmr_peaks(leaves: list[bytes]) -> list[bytes]:
    """The MMR peak list of ``leaves``: one perfect-binary-tree root per
    set bit of len(leaves), largest tree first — exactly the peak
    structure sequential MMR appends produce. Each tree reduces level by
    level through the batched pair hasher."""
    peaks = []
    pos = 0
    n = len(leaves)
    for bit in range(n.bit_length() - 1, -1, -1):
        size = 1 << bit
        if not n & size:
            continue
        level = leaves[pos:pos + size]
        pos += size
        while len(level) > 1:
            level = _hash_level(
                [level[i] + level[i + 1] for i in range(0, len(level), 2)])
        peaks.append(level[0])
    return peaks


def mmr_root(leaves: list[bytes]) -> bytes:
    """Bag the peaks right-to-left (acc = H(peak || acc)) into one root.
    Empty input is a caller bug — a snapshot always has genesis."""
    peaks = mmr_peaks(leaves)
    if not peaks:
        raise CertificateError("MMR over zero leaves")
    acc = peaks[-1]
    for peak in reversed(peaks[:-1]):
        acc = _sha256d(peak + acc)
    return acc


# -- epoch trajectory -------------------------------------------------------

def checkpoint_heights(height: int, epoch_blocks: int) -> list[int]:
    """The certificate's committed checkpoint heights: every multiple of
    E up to H, plus the tail checkpoint H itself when H % E != 0. Always
    non-empty and always ending at H."""
    if height < 1 or epoch_blocks < 1:
        raise CertificateError(
            f"bad trajectory shape: height={height} E={epoch_blocks}")
    hs = list(range(epoch_blocks, height + 1, epoch_blocks))
    if not hs or hs[-1] != height:
        hs.append(height)
    return hs


def epoch_trajectory(final_state: int, deltas: Iterable[tuple],
                     height: int, epoch_blocks: int) -> list[dict]:
    """Rebuild the per-epoch digest trajectory from the final accumulator
    state by walking block deltas tip->1.

    ``deltas`` yields ``(h, created, spent)`` for h = height..1 in strictly
    descending order, where created/spent are lists of ``(key36, coin_ser)``
    rows exactly as the store persists them (undo data supplies the spent
    side). Because the accumulator group is abelian, the state AT any
    checkpoint c equals final_state * prod(spent above c) / prod(created
    above c) — the division costs one modular inverse per checkpoint.
    Returns ascending ``[{"height": h, "muhash": hex}, ...]`` ending at
    ``height`` with the digest of ``final_state`` itself."""
    targets = checkpoint_heights(height, epoch_blocks)
    out = [{"height": height,
            "muhash": muhash.digest_of(final_state).hex()}]
    remaining = [h for h in targets if h != height]
    if not remaining:
        return out
    lowest = remaining[0]
    num = 1  # product of spent elements above the current height
    den = 1  # product of created elements above the current height
    expect = height
    for h, created, spent in deltas:
        if h != expect:
            raise CertificateError(
                f"delta walk out of order: got height {h}, want {expect}")
        expect -= 1
        if created:
            den = den * muhash.batch_product(
                [muhash.coin_element(k, s) for k, s in created]
            ) % muhash.MUHASH_P
        if spent:
            num = num * muhash.batch_product(
                [muhash.coin_element(k, s) for k, s in spent]
            ) % muhash.MUHASH_P
        if h - 1 == remaining[-1]:
            state = (final_state * num % muhash.MUHASH_P
                     * pow(den, -1, muhash.MUHASH_P)) % muhash.MUHASH_P
            out.append({"height": h - 1,
                        "muhash": muhash.digest_of(state).hex()})
            remaining.pop()
            if not remaining:
                break
        if h - 1 < lowest:
            break
    if remaining:
        raise CertificateError(
            f"delta walk ended before checkpoints {remaining}")
    out.reverse()
    return out


# -- commitment chain -------------------------------------------------------

def commitment_chain(root: bytes, height: int, epoch_blocks: int,
                     epochs: list[dict]) -> bytes:
    """c_0 = H(tag || mmr_root || LE64(H) || LE32(E)); each checkpoint
    then links c_i = H(c_{i-1} || LE64(h_i) || digest_i). The final link
    covers the snapshot set digest, so the chain binds headers ->
    trajectory -> final digest as one recursively-committed value."""
    c = _sha256d(_CHAIN_TAG + root + struct.pack("<QI", height, epoch_blocks))
    for ep in epochs:
        c = _sha256d(c + struct.pack("<Q", int(ep["height"]))
                     + bytes.fromhex(ep["muhash"]))
    return c


# -- build / verify ---------------------------------------------------------

def build_certificate(header_hashes: list[bytes], height: int,
                      epoch_blocks: int, final_state: int,
                      deltas: Iterable[tuple]) -> dict:
    """Produce the certificate dict at dumptxoutset time.

    ``header_hashes`` are the block hashes genesis..H in height order
    (len == H+1); ``deltas`` feeds :func:`epoch_trajectory`. The armed
    ``snapshot_cert`` poison hook forges one mid-trajectory epoch digest
    BEFORE the commitment chain is sealed — the internally-consistent
    forgery the epoch-divergence drills must catch."""
    if len(header_hashes) != height + 1:
        raise CertificateError(
            f"{len(header_hashes)} header hashes for height {height}")
    epochs = epoch_trajectory(final_state, deltas, height, epoch_blocks)
    if INJECTOR.should_poison(SNAPSHOT_CERT_SITE) and len(epochs) >= 2:
        forge = epochs[(len(epochs) - 1) // 2]
        raw = bytearray(bytes.fromhex(forge["muhash"]))
        raw[0] ^= 0x01
        forge["muhash"] = bytes(raw).hex()
        log_printf("snapshot_cert: POISONED epoch %d digest (drill)",
                   forge["height"])
    root = mmr_root(header_hashes)
    return {
        "version": CERT_VERSION,
        "height": height,
        "headers": height + 1,
        "epoch_blocks": epoch_blocks,
        "mmr_root": root.hex(),
        "epochs": epochs,
        "commitment": commitment_chain(
            root, height, epoch_blocks, epochs).hex(),
    }


def verify_certificate(cert: dict, header_hashes: list[bytes],
                       height: int, set_digest_hex: str) -> dict:
    """Structural verification at loadtxoutset, BEFORE any row is
    streamed: recompute the MMR root over the snapshot's own headers,
    require complete ascending epoch coverage, recompute the commitment
    chain, and require the final trajectory digest to equal the manifest
    set digest. Raises CertificateError on any mismatch (the caller takes
    the wipe-and-reject path). Returns ``{height: digest_hex}`` — the
    checkpoint map the background shadow validator checks itself against
    as it replays history."""
    INJECTOR.on_call(SNAPSHOT_CERT_SITE)
    if not isinstance(cert, dict) or cert.get("version") != CERT_VERSION:
        raise CertificateError("missing or unknown certificate version")
    if int(cert.get("height", -1)) != height:
        raise CertificateError(
            f"certificate height {cert.get('height')} != snapshot {height}")
    if int(cert.get("headers", -1)) != len(header_hashes) or \
            len(header_hashes) != height + 1:
        raise CertificateError("certificate header count mismatch")
    epoch_blocks = int(cert.get("epoch_blocks", 0))
    epochs = cert.get("epochs") or []
    try:
        want_heights = checkpoint_heights(height, epoch_blocks)
    except CertificateError:
        raise CertificateError(
            f"certificate epoch stride {epoch_blocks} invalid") from None
    got_heights = [int(ep.get("height", -1)) for ep in epochs]
    if got_heights != want_heights:
        raise CertificateError(
            "certificate epoch trajectory is truncated or misaligned "
            f"(got {len(got_heights)} checkpoints, want {len(want_heights)})")
    for ep in epochs:
        if len(bytes.fromhex(ep.get("muhash", ""))) != 32:
            raise CertificateError("malformed epoch digest")
    if epochs[-1]["muhash"] != set_digest_hex:
        raise CertificateError(
            "certificate final digest does not cover the snapshot digest")
    root = mmr_root(header_hashes)
    if root.hex() != cert.get("mmr_root"):
        raise CertificateError(
            "certificate MMR root does not match the snapshot headers")
    want_c = commitment_chain(root, height, epoch_blocks, epochs)
    if want_c.hex() != cert.get("commitment"):
        raise CertificateError("certificate commitment chain broken")
    return {int(ep["height"]): ep["muhash"] for ep in epochs}


# -- spot-check sampling ----------------------------------------------------

def sample_epochs(cert_epochs: list[int], k: int,
                  seed: Optional[int] = None) -> list[int]:
    """Seeded draw of ``k`` certificate-committed checkpoint heights for
    ``-snapshotspotcheck``. The FINAL checkpoint is always included (the
    whole-set digest equality is never sampled away); the remaining k-1
    come from a deterministic shuffle of the earlier checkpoints, so one
    seed replays the identical drill. k >= len(cert_epochs) degrades to
    full coverage."""
    if not cert_epochs:
        return []
    heights = sorted(cert_epochs)
    final = heights[-1]
    rest = heights[:-1]
    if k >= len(heights):
        return heights
    rng = random.Random(seed)
    rng.shuffle(rest)
    return sorted(rest[:max(0, k - 1)] + [final])
