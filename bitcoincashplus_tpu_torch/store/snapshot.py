"""UTXO snapshot serialization — the assumeutxo onboarding format.

Reference: Bitcoin Core's dumptxoutset/loadtxoutset (node/utxo_snapshot.h)
reshaped for the sharded store: a snapshot is a DIRECTORY holding

  MANIFEST.json   version, network, height, best block hash, coin count,
                  the MuHash set digest, and per-file sha256 checksums
  headers.dat     the 80-byte headers genesis..tip, concatenated — the
                  loading node installs these through the normal
                  accept_block_header PoW checks, no trust needed
  utxo-NN.dat     one stream per source shard: repeated
                  (key36 | LE32 value-length | Coin serialization)

The digest is partition-independent (store/muhash.py), so a snapshot
dumped from an N-shard store loads into an M-shard store: rows are
re-partitioned by the target's shard function while the set digest is
recomputed and must match the manifest AND the operator-supplied
``-assumeutxo=<hash:digest>`` authorization before any of it becomes the
node's chainstate.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Optional

from ..util.log import log_printf
from . import muhash
from .certificate import CERT_NAME, CertificateError, verify_certificate
from .kvstore import atomic_write_json, read_json
from .sharded import ShardedCoinsDB, shard_of

SNAPSHOT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
HEADERS_NAME = "headers.dat"
_ROW_HDR = struct.Struct("<36sI")
_CHUNK_ROWS = 16384


class SnapshotError(Exception):
    """A snapshot that failed structural or digest verification."""


def _shard_streams(coins_db):
    """[(stream_index, row_iterator)] for any coins backend."""
    if isinstance(coins_db, ShardedCoinsDB):
        return [(i, coins_db.iterate_shard_coins(i))
                for i in range(coins_db.n_shards)]
    return [(0, coins_db.iterate_coins())]


def dump_snapshot(coins_db, path: str, headers: list[bytes],
                  height: int, best_block: bytes, network: str,
                  certificate: Optional[dict] = None) -> dict:
    """Write a snapshot directory at ``path`` from the PERSISTED coin set
    (the caller flushes first). When the dumping node supplies a
    proof-carrying ``certificate`` (store/certificate.py) it is written
    alongside as CERTIFICATE.json — self-authenticating via its own
    commitment chain, so the manifest does not checksum it. Returns the
    manifest dict."""
    os.makedirs(path, exist_ok=True)
    hdr_blob = b"".join(headers)
    with open(os.path.join(path, HEADERS_NAME), "wb") as f:
        f.write(hdr_blob)

    files = []
    total_coins = 0
    acc = 1
    elems: list[int] = []
    for stream_i, rows in _shard_streams(coins_db):
        name = f"utxo-{stream_i:02d}.dat"
        h = hashlib.sha256()
        n = 0
        nbytes = 0
        with open(os.path.join(path, name), "wb") as f:
            for key36, ser in rows:
                rec = _ROW_HDR.pack(key36, len(ser)) + ser
                f.write(rec)
                h.update(rec)
                n += 1
                nbytes += len(rec)
                elems.append(muhash.coin_element(key36, ser))
                if len(elems) >= _CHUNK_ROWS:
                    acc = acc * muhash.batch_product(elems) % muhash.MUHASH_P
                    elems = []
        total_coins += n
        files.append({"name": name, "coins": n, "bytes": nbytes,
                      "sha256": h.hexdigest()})
    if elems:
        acc = acc * muhash.batch_product(elems) % muhash.MUHASH_P

    manifest = {
        "version": SNAPSHOT_VERSION,
        "network": network,
        "height": height,
        "best_block": best_block[::-1].hex(),
        "coins": total_coins,
        "muhash": muhash.digest_of(acc).hex(),
        "files": files,
        "headers": {"file": HEADERS_NAME, "count": len(headers),
                    "sha256": hashlib.sha256(hdr_blob).hexdigest()},
    }
    atomic_write_json(os.path.join(path, MANIFEST_NAME), manifest)
    if certificate is not None:
        atomic_write_json(os.path.join(path, CERT_NAME), certificate)
    log_printf("dumptxoutset: %d coins at height %d -> %s (digest %s%s)",
               total_coins, height, path, manifest["muhash"][:16],
               ", certified" if certificate is not None else "")
    return manifest


def _iter_rows(path: str, expect_sha: str):
    """Yield (key36, ser) records from one utxo stream, verifying the
    file checksum as a side effect (raises SnapshotError at EOF on
    mismatch or on a torn record)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            head = f.read(_ROW_HDR.size)
            if not head:
                break
            if len(head) < _ROW_HDR.size:
                raise SnapshotError(f"torn record header in {path}")
            key36, vlen = _ROW_HDR.unpack(head)
            ser = f.read(vlen)
            if len(ser) < vlen:
                raise SnapshotError(f"torn record value in {path}")
            h.update(head)
            h.update(ser)
            yield key36, ser
    if h.hexdigest() != expect_sha:
        raise SnapshotError(f"checksum mismatch for {path}")


def load_snapshot(path: str, coins_db: ShardedCoinsDB, network: str,
                  expected_hash: Optional[bytes] = None,
                  expected_digest: Optional[bytes] = None,
                  require_certificate: bool = False) -> dict:
    """Stream a snapshot into ``coins_db`` (re-partitioned to its shard
    count), verify the recomputed set digest against the manifest and the
    operator authorization BEFORE stamping any chainstate meta, and
    return {height, best_block, headers(list of 80-byte blobs),
    manifest, certificate, cert_checkpoints}. On any failure the loaded
    rows are wiped.

    If the snapshot carries CERTIFICATE.json it is verified BEFORE a
    single row is streamed: wrong MMR root over the snapshot's own
    headers, truncated epoch trajectory, or a bit-flipped certificate all
    raise SnapshotError and take the same wipe-and-reject path as a wrong
    set digest — the chainstate is never half-loaded. On success
    ``cert_checkpoints`` maps epoch height -> expected MuHash digest hex
    for the background shadow validator to check itself against as it
    replays. ``require_certificate`` (``-snapshotcertrequired``) refuses
    certificate-less snapshots outright; without it they still load but
    the node quarantines them from serving until fully validated."""
    manifest = read_json(os.path.join(path, MANIFEST_NAME))
    if not manifest or manifest.get("version") != SNAPSHOT_VERSION:
        raise SnapshotError(f"missing or unreadable {MANIFEST_NAME}")
    if manifest.get("network") != network:
        raise SnapshotError(
            f"snapshot network {manifest.get('network')!r} != {network!r}")
    best_block = bytes.fromhex(manifest["best_block"])[::-1]
    if expected_hash is not None and best_block != expected_hash:
        raise SnapshotError(
            "snapshot tip %s does not match the -assumeutxo hash" %
            manifest["best_block"][:16])
    if expected_digest is not None and \
            manifest["muhash"] != expected_digest.hex():
        raise SnapshotError(
            "snapshot manifest digest does not match -assumeutxo")

    hdr_path = os.path.join(path, manifest["headers"]["file"])
    with open(hdr_path, "rb") as f:
        hdr_blob = f.read()
    if hashlib.sha256(hdr_blob).hexdigest() != manifest["headers"]["sha256"] \
            or len(hdr_blob) != 80 * manifest["headers"]["count"]:
        raise SnapshotError("headers stream corrupt")
    headers = [hdr_blob[i:i + 80] for i in range(0, len(hdr_blob), 80)]

    certificate = read_json(os.path.join(path, CERT_NAME))
    if require_certificate and not certificate:
        raise SnapshotError(
            "snapshot carries no certificate and -snapshotcertrequired is "
            "set — refusing trust-me onboarding")

    n = coins_db.n_shards
    shard_states = [1] * n
    pending_elems: list[list[int]] = [[] for _ in range(n)]
    rows: list[tuple[bytes, bytes]] = []
    total = 0

    def _flush_rows():
        nonlocal rows
        coins_db.ingest_rows(rows)
        rows = []
        for i in range(n):
            if pending_elems[i]:
                shard_states[i] = (shard_states[i] *
                                   muhash.batch_product(pending_elems[i])
                                   ) % muhash.MUHASH_P
                pending_elems[i] = []

    cert_checkpoints: Optional[dict] = None
    try:
        if certificate:
            # fail-fast leg: a bad certificate costs seconds (batched
            # header-MMR recompute + one hash chain), not a streamed-in
            # chainstate — and any failure still exits through the same
            # clear_coins() wipe as a digest mismatch, so a fault-injected
            # mid-verify crash (snapshot_cert fail-*) provably cannot
            # leave rows behind
            from ..crypto.hashes import sha256d
            try:
                cert_checkpoints = verify_certificate(
                    certificate, [sha256d(h) for h in headers],
                    manifest["height"], manifest["muhash"])
            except CertificateError as e:
                raise SnapshotError(f"snapshot certificate rejected: {e}")
            log_printf("loadtxoutset: certificate verified (%d epoch "
                       "checkpoints, stride %d)", len(cert_checkpoints),
                       certificate["epoch_blocks"])
        for entry in manifest["files"]:
            for key36, ser in _iter_rows(os.path.join(path, entry["name"]),
                                         entry["sha256"]):
                rows.append((key36, ser))
                pending_elems[shard_of(key36, n)].append(
                    muhash.coin_element(key36, ser))
                total += 1
                if len(rows) >= _CHUNK_ROWS:
                    _flush_rows()
        _flush_rows()
        if total != manifest["coins"]:
            raise SnapshotError(
                f"coin count {total} != manifest {manifest['coins']}")
        digest = muhash.digest_of(muhash.combine(shard_states))
        if digest.hex() != manifest["muhash"]:
            raise SnapshotError(
                "recomputed set digest does not match the manifest")
        if expected_digest is not None and digest != expected_digest:
            raise SnapshotError(
                "recomputed set digest does not match -assumeutxo")
    except Exception:
        coins_db.clear_coins()
        raise

    coins_db.finalize_bulk_load(
        best_block, shard_states,
        snapshot={"height": manifest["height"],
                  "hash": manifest["best_block"],
                  "digest": manifest["muhash"],
                  "validated": False,
                  "cert": {"present": bool(certificate),
                           "verified": bool(certificate),
                           "epoch_blocks": (certificate or {}).get(
                               "epoch_blocks", 0),
                           "epochs": len(cert_checkpoints or {})}})
    log_printf("loadtxoutset: %d coins at height %d (digest %s) — "
               "serving at the snapshot tip, history pending%s",
               total, manifest["height"], manifest["muhash"][:16],
               "" if certificate else
               " (UNCERTIFIED: quarantined from fleet serving until "
               "fully validated)")
    return {"height": manifest["height"], "best_block": best_block,
            "headers": headers, "manifest": manifest,
            "certificate": certificate,
            "cert_checkpoints": cert_checkpoints}
