"""Address manager — bucketed known-peer bookkeeping + peers.dat persistence.

Reference: src/addrman.{h,cpp} (CAddrMan: 1024 new / 256 tried buckets of 64
slots, per-source-group bucketing, Select/Good/Attempt/Add), src/net.cpp
(DumpAddresses/LoadAddresses via CAddrDB → peers.dat).

Eclipse resistance comes from the INSERTION constraints, reproduced here:
  - a (new) address's bucket is derived from sip-hashing (secret key,
    address group, SOURCE group) — one source group can reach at most
    64 of the 1024 new buckets, so a single attacker announcing thousands
    of addresses can fill at most 64*64 slots, not the table;
  - a full slot is only re-used when its incumbent is stale/terrible, so
    flooding cannot displace healthy addresses;
  - tried placement keys off the address itself; a collision displaces the
    incumbent back to the new table (the pre-test-before-evict reference
    behavior) rather than silently dropping either.

Documented simplifications vs the reference: one new-table reference per
address (the reference allows up to 8 via distinct sources), and Select
walks the eligible-entry set directly instead of random bucket probing —
the bucket layout constrains CAPACITY and placement (the eclipse defense);
selection fairness differences at loopback scale are noise.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Optional

from ..crypto.siphash import siphash24

NEW_BUCKETS = 1024
TRIED_BUCKETS = 256
BUCKET_SIZE = 64
NEW_BUCKETS_PER_SOURCE_GROUP = 64
TRIED_BUCKETS_PER_GROUP = 8

# horizon/retry limits (addrman.h ADDRMAN_* constants)
HORIZON_DAYS = 30
MAX_RETRIES = 3
MAX_ADDRESSES = 1000  # per getaddr reply (MAX_ADDR_TO_SEND, net.h)


class AddrInfo:
    __slots__ = ("host", "port", "services", "time", "attempts",
                 "last_try", "tried", "source")

    def __init__(self, host: str, port: int, services: int = 1,
                 seen_time: Optional[int] = None,
                 source: Optional[str] = None):
        self.host = host
        self.port = port
        self.services = services
        self.time = seen_time if seen_time is not None else int(time.time())
        self.attempts = 0
        self.last_try = 0.0
        self.tried = False
        self.source = source if source is not None else host

    @property
    def key(self) -> str:
        return f"{self.host}:{self.port}"

    def to_dict(self) -> dict:
        return {"host": self.host, "port": self.port,
                "services": self.services, "time": self.time,
                "attempts": self.attempts, "tried": self.tried,
                "source": self.source}

    @classmethod
    def from_dict(cls, d: dict) -> "AddrInfo":
        a = cls(d["host"], int(d["port"]), int(d.get("services", 1)),
                int(d.get("time", 0)), d.get("source"))
        # attempts deliberately reset: a restart gives every stored
        # address a fresh chance (the failure history was this-session)
        a.tried = bool(d.get("tried", False))
        return a


def _group(host: str) -> str:
    """Network group (netaddress GetGroup): /16 for IPv4, the literal host
    otherwise (IPv6/onion grouping collapsed — loopback deployments)."""
    parts = host.split(".")
    if len(parts) == 4 and all(p.isdigit() for p in parts):
        return parts[0] + "." + parts[1]
    return host


class AddrMan:
    def __init__(self, seed: Optional[int] = None):
        self.addrs: dict[str, AddrInfo] = {}
        self._rng = random.Random(seed)
        # nKey — the secret bucketing key (persisted: rebucketing on every
        # restart would let an observer correlate placements). Bucket
        # placement is the eclipse defense, so the key comes from a CSPRNG
        # like the reference's nKey (ADVICE r4) — the deterministic seed
        # stays test-only.
        if seed is None:
            import secrets

            self._k0 = secrets.randbits(64)
            self._k1 = secrets.randbits(64)
        else:
            self._k0 = self._rng.getrandbits(64)
            self._k1 = self._rng.getrandbits(64)
        # (bucket, slot) -> addr key; inverse position map on the side
        self.new_tbl: dict[tuple, str] = {}
        self.tried_tbl: dict[tuple, str] = {}
        self._pos: dict[str, tuple] = {}  # addr key -> ("new"/"tried", b, s)

    def __len__(self) -> int:
        return len(self.addrs)

    # -- bucket math (CAddrMan::GetNewBucket/GetTriedBucket) -------------

    def _h(self, *parts: str) -> int:
        return siphash24(self._k0, self._k1, "|".join(parts).encode())

    def _new_bucket(self, host: str, source: str) -> int:
        h1 = self._h("N1", _group(host), _group(source)) \
            % NEW_BUCKETS_PER_SOURCE_GROUP
        return self._h("N2", _group(source), str(h1)) % NEW_BUCKETS

    def _tried_bucket(self, key: str, host: str) -> int:
        h1 = self._h("T1", key) % TRIED_BUCKETS_PER_GROUP
        return self._h("T2", _group(host), str(h1)) % TRIED_BUCKETS

    def _slot(self, table: str, bucket: int, key: str) -> int:
        return self._h("S", table, str(bucket), key) % BUCKET_SIZE

    def _is_terrible(self, info: AddrInfo, now: Optional[float] = None) -> bool:
        """CAddrInfo::IsTerrible — eviction eligibility for a slot
        incumbent."""
        now = now if now is not None else time.time()
        if info.time > now + 600:
            return True  # nonsense future timestamp
        if info.time < now - HORIZON_DAYS * 86400:
            return True  # over the horizon
        return info.attempts >= MAX_RETRIES

    # -- table surgery ---------------------------------------------------

    def _drop(self, key: str) -> None:
        pos = self._pos.pop(key, None)
        if pos is not None:
            tbl = self.new_tbl if pos[0] == "new" else self.tried_tbl
            tbl.pop((pos[1], pos[2]), None)
        self.addrs.pop(key, None)

    def _place_new(self, info: AddrInfo, force: bool = False) -> bool:
        """Insert into the new table; False = dropped (healthy incumbent).
        ``force`` evicts the incumbent regardless — used when re-homing a
        PROVEN-good address displaced from the tried table, which must not
        lose to an unvetted gossip entry (CAddrMan::MakeTried clears the
        slot for the demotee)."""
        b = self._new_bucket(info.host, info.source)
        s = self._slot("new", b, info.key)
        incumbent_key = self.new_tbl.get((b, s))
        if incumbent_key is not None and incumbent_key != info.key:
            incumbent = self.addrs.get(incumbent_key)
            if (not force and incumbent is not None
                    and not self._is_terrible(incumbent)):
                return False  # slot defended: the flood is absorbed here
            self._drop(incumbent_key)
        self.new_tbl[(b, s)] = info.key
        self._pos[info.key] = ("new", b, s)
        self.addrs[info.key] = info
        return True

    # -- public lifecycle (Add/Attempt/Good/Select) ----------------------

    def add(self, host: str, port: int, services: int = 1,
            seen_time: Optional[int] = None,
            source: Optional[str] = None) -> bool:
        """CAddrMan::Add — new address into the 'new' side; refreshes the
        timestamp of a known one. ``source`` is the gossiping peer (the
        eclipse-critical input: it picks which 64 buckets are reachable)."""
        info = AddrInfo(host, port, services, seen_time, source)
        cur = self.addrs.get(info.key)
        if cur is not None:
            cur.time = max(cur.time, info.time)
            cur.services |= services
            return False
        return self._place_new(info)

    def attempt(self, host: str, port: int) -> None:
        cur = self.addrs.get(f"{host}:{port}")
        if cur is not None:
            cur.attempts += 1
            cur.last_try = time.time()

    def good(self, host: str, port: int) -> None:
        """CAddrMan::Good — successful handshake moves it to 'tried'. A
        tried-slot collision displaces the incumbent back to the new table
        (reference pre-test-before-evict semantics)."""
        key = f"{host}:{port}"
        cur = self.addrs.get(key)
        if cur is None:
            cur = AddrInfo(host, port)
            if not self._place_new(cur):
                return  # table defended the slot; nothing to promote
        cur.attempts = 0
        cur.time = int(time.time())
        if cur.tried:
            return  # already in tried
        b = self._tried_bucket(key, host)
        s = self._slot("tried", b, key)
        incumbent_key = self.tried_tbl.get((b, s))
        # leave the new table
        pos = self._pos.pop(key, None)
        if pos is not None and pos[0] == "new":
            self.new_tbl.pop((pos[1], pos[2]), None)
        if incumbent_key is not None and incumbent_key != key:
            incumbent = self.addrs.get(incumbent_key)
            self.tried_tbl.pop((b, s), None)
            self._pos.pop(incumbent_key, None)
            if incumbent is not None:
                # demoted-but-proven address: force-home it in the new
                # table (it must beat any unvetted gossip incumbent)
                incumbent.tried = False
                self._place_new(incumbent, force=True)
        cur.tried = True
        self.tried_tbl[(b, s)] = key
        self._pos[key] = ("tried", b, s)

    def select(self, exclude: Optional[set[str]] = None) -> Optional[AddrInfo]:
        """CAddrMan::Select — pick a dial candidate, preferring tried,
        skipping recently failed and excluded (connected) addresses."""
        exclude = exclude or set()
        now = time.time()
        # IsTerrible is time-windowed in the reference, not permanent:
        # past MAX_RETRIES an address still gets another chance once an
        # hour, so a transiently-down peer is eventually redialed
        candidates = [
            a for a in self.addrs.values()
            if a.key not in exclude
            and (a.attempts <= MAX_RETRIES or now - a.last_try > 3600)
            and now - a.last_try > 10 * min(a.attempts + 1, 6)
        ]
        if not candidates:
            return None
        tried = [a for a in candidates if a.tried]
        pool = tried if tried and self._rng.random() < 0.5 else candidates
        return self._rng.choice(pool)

    def addresses(self, max_count: int = MAX_ADDRESSES) -> list[AddrInfo]:
        """GetAddr: a random sample for getaddr replies, fresh ones only."""
        horizon = time.time() - HORIZON_DAYS * 86400
        fresh = [a for a in self.addrs.values() if a.time > horizon]
        self._rng.shuffle(fresh)
        return fresh[:max_count]

    # -- persistence (peers.dat role; json like the wallet/mempool) ------

    def save(self, path: str) -> None:
        tmp = path + ".new"
        with open(tmp, "w") as f:
            json.dump({"version": 2,
                       "key": [self._k0, self._k1],
                       "addrs": [a.to_dict() for a in self.addrs.values()]},
                      f)
        os.replace(tmp, path)

    def load(self, path: str) -> int:
        if not os.path.exists(path):
            return 0
        try:
            with open(path) as f:
                payload = json.load(f)
            key = payload.get("key")
            if isinstance(key, list) and len(key) == 2:
                self._k0, self._k1 = int(key[0]), int(key[1])
            for d in payload.get("addrs", []):
                a = AddrInfo.from_dict(d)
                was_tried = a.tried
                a.tried = False
                if not self._place_new(a):
                    continue  # bucket collision on load: drop, like CAddrDB
                if was_tried:
                    self.good(a.host, a.port)
                    got = self.addrs.get(a.key)
                    if got is not None:
                        got.time = a.time  # good() stamped now; restore
                        got.services = a.services
        except (OSError, ValueError, KeyError):
            return 0  # corrupt peers file must never stop the node
        return len(self.addrs)
