"""Flag and configuration handling — the ArgsManager analogue.

Reference: src/util.cpp:~400-600 (ParseParameters, ReadConfigFile, GetArg /
GetBoolArg / GetArgs, SoftSetArg), src/chainparamsbase.cpp (network
selection / datadir subdirectories), src/init.cpp:~350-600 (HelpMessage).

Bitcoin-style flags: `-name=value` or bare `-name` (boolean true); a
leading `-no` negates (`-nolisten` == `-listen=0`). Precedence is
CLI > config file, matching the reference (config-file values are
soft-set only where the CLI didn't supply the arg). `--name` is accepted
as an alias for `-name` (the reference strips the extra dash too), which
is how `--tpu` arrives.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Optional

from ..consensus.params import ChainParams, select_params
from ..consensus.serialize import hex_to_hash

DEFAULT_DATADIR = "~/.bitcoincashplus-tpu"

HELP_MESSAGE = """\
bcpd — TPU-native bitcoincashplus node daemon

Options:
  -?, -help              Print this help message and exit
  -datadir=<dir>         Specify data directory (default: ~/.bitcoincashplus-tpu)
  -conf=<file>           Config file name (default: bitcoin.conf in datadir)
  -regtest               Use the regression test network
  -testnet               Use the test network
  -reindex               Rebuild chain state and block index from blk*.dat files
  -txindex               Maintain a full transaction index (default: 0)
  -par=<n>               Script verification batch backend threads; 0 = auto (default: 0)
  -dbcache=<n>           Database cache size in MiB (default: 300)
  -coinshards=<n>        Hash-partition fan-out of the sharded chainstate
                         store: power of two in [1, 256] (default: 4). An
                         existing sharded datadir's manifest pins the count;
                         legacy single-file datadirs stay on the old layout
                         until -reindex
  -coinswal              Per-shard WAL commit discipline: sync'd shard
                         flushes fsync the sqlite WAL at COMMIT
                         (synchronous=FULL) instead of running a full
                         wal_checkpoint per flush. Equal durability for
                         committed batches; trades checkpoint latency in
                         the parallel shard flush for WAL-fsync latency
                         at commit (default: 0)
  -assumeutxo=<hash:muhash>  Authorize loadtxoutset to adopt a UTXO snapshot
                         with exactly this tip block hash and MuHash set
                         digest (both 32-byte hex). The node serves at the
                         snapshot tip immediately while background
                         validation replays history into a shadow
                         chainstate and promotes on digest equality
  -snapshotepoch=<n>     Epoch stride (blocks) for the proof-carrying
                         snapshot certificate built at dumptxoutset: the
                         certified MuHash trajectory commits one digest
                         checkpoint every <n> blocks (default: 64)
  -snapshotspotcheck=<k> Background snapshot validation re-runs full script
                         checks on only <k> seeded-drawn certified epochs
                         (the final epoch always included) instead of all
                         of history; certificate digest tripwires still
                         fire at every epoch boundary (default: 0 = full
                         re-validation)
  -snapshotcertrequired  Refuse loadtxoutset snapshots that carry no
                         certificate instead of loading them quarantined
                         (default: 0)
  -checkblocks=<n>       How many blocks to verify at startup (default: 6)
  -checklevel=<n>        How thorough the startup block verification is (0-4, default: 3)
  -assumevalid=<hex>     Skip script verification for ancestors of this block
                         (0 = verify everything)
  -debug=<category>      Enable debug logging (all|net|mempool|rpc|bench|db|validation|tpu)
  -printtoconsole        Send trace/debug info to console instead of debug.log only
  -logjson               Write debug.log records as JSON objects stamped with the
                         active telemetry span's correlation id (default: 0)
  -telemetry=<level>     Telemetry level: off = disabled, counters = metrics
                         registry (getmetrics RPC + /metrics Prometheus text;
                         default, <2% overhead), trace = counters + pipeline
                         span tracing (dumptrace RPC / -tracefile); unknown
                         values are rejected at startup
  -tracefile=<path>      Dump the span trace (Chrome/perfetto JSON) to <path>
                         at shutdown; implies -telemetry=trace (an explicit
                         lower -telemetry level alongside it is rejected)
  -maxmempool=<n>        Max transaction memory pool size in MiB (default: 300)
  -mempoolexpiry=<n>     Do not keep transactions in mempool longer than <n> hours (default: 336)
  -mempoolbatch=<0|1>    Batch-shaped mempool: numpy aggregate columns,
                         incremental mining/eviction frontiers, staged bulk
                         removal (default: 1; 0 pins the per-tx reference
                         paths — the differential-test control)
  -mempoolselfcheck=<0|1>
                         Re-derive every batched template-selection and
                         eviction verdict through the per-tx oracle and log
                         divergence (debug, like -checkmempool; default: 0)
  -minrelaytxfee=<amt>   Minimum relay fee rate in satoshis/kB (default: 1000)
  -tpu=<0|1>             Use the TPU batch backend for sig verification and
                         mining sweeps (default: auto-detect)
  -ecdsakernel=<glv|w4|msm>
                         Device ECDSA verify kernel: glv = endomorphism-split
                         ladder + fixed-base G comb (default), w4 = the
                         64-window kernel (kept as oracle/fallback), msm =
                         Pippenger multi-scalar batch check for SCHNORR lanes
                         (one point-at-infinity verdict per batch; rejected
                         batches bisect to the per-lane oracle — worth it from
                         a few dozen Schnorr sigs per batch, ECDSA lanes keep
                         riding glv); unknown values are rejected at startup
  -compilecache=<dir>    Persistent XLA compilation cache directory (default:
                         off). First compile of each kernel shape writes the
                         cache; every later process start reads it instead of
                         re-paying the ~90 s cold GLV compile. Seeds
                         BCP_COMPILE_CACHE for child processes; cache hits
                         surface in gettpuinfo.device.compilation_cache
  -residentminer=<on|off|force>  Device-resident mining loop: the nonce sweep
                         runs as a persistent segment pipeline over
                         long-lived template buffers (refresh = buffer swap,
                         not a new dispatch). Default: on; off = the
                         per-dispatch sweep; force = resident even on a
                         regtest CPU node (test/bench hook — those otherwise
                         keep the scalar host fast path); unknown values are
                         rejected at startup
  -sigservice=<on|off>   Run the always-on micro-batching signature service:
                         mempool ingest and tip relay enqueue script checks
                         into shared device lanes behind a flush deadline
                         (default: on; off = synchronous verification,
                         verdicts identical)
  -sigservicedeadline=<ms>  Max milliseconds a partial signature bucket may
                         wait for more lanes before flushing (default: 4;
                         0 = flush on every enqueue)
  -sigservicelanes=<n>   Signature-service bucket size in lanes (default:
                         2046 — fills the 2048 device bucket with the two
                         known-answer probe lanes)
  -port=<port>           Listen for P2P connections on <port>
  -listen                Accept P2P connections from outside (default: 1 when P2P enabled)
  -connect=<ip:port>     Connect only to the specified node (may be repeated)
  -banscore=<n>          Ban-score threshold: misbehaving peers are evicted
                         once their score reaches <n> (default: 100)
  -blockdownloadtimeout=<n>  Seconds without download progress before a peer
                         with blocks in flight counts as stalling (default: 60)
  -maxrecvrate=<n>       Per-peer receive ceiling in bytes/sec averaged over
                         one supervision tick; 0 = unlimited (default: 4000000)
  -maxunconnectingheaders=<n>  Charge the non-connecting-headers misbehavior
                         only every <n>th offense since the peer's last
                         connecting batch (default: 10)
  -nettick=<n>           P2P supervision tick interval in seconds (default: 5)
  -netseed=<n>           Seed for the network rng (orphan eviction); -1 = OS
                         entropy (default: -1)
  -backfilltimeout=<n>   Seconds before an assumeutxo backfill request is
                         torn off its peer and retried on another (default:
                         min(10, -blockdownloadtimeout))
  -rpcport=<port>        Listen for JSON-RPC connections on <port>
  -rpcbind=<addr>        Bind RPC to address (default: 127.0.0.1)
  -rpcuser=<user>        Username for JSON-RPC connections (default: cookie auth)
  -rpcpassword=<pw>      Password for JSON-RPC connections
  -server                Accept JSON-RPC commands (default: 1 for bcpd)
  -gateway=<port>        Run the fleet serving front door on <port>: a
                         load-balancing JSON-RPC gateway over the -replicas
                         pool with per-client token-bucket admission,
                         graduated shedding, request coalescing and
                         mid-request failover (default: off)
  -replicas=<host:port,...>  Read-replica RPC endpoints behind -gateway
                         (snapshot-bootstrapped bcpd nodes sharing this
                         node's -rpcuser/-rpcpassword)
  -maxreplicalag=<n>     Consistency gate: rotate a replica out of serving
                         once its probed tip lags the pool fan-out height
                         by more than <n> blocks (default: 2)
  -gatewayrate=<n>       Per-client admission refill in requests/sec
                         (default: 500); -gatewayburst=<n> bucket capacity
                         (default: 200); -gatewaysoft/-gatewayhard in-flight
                         ceilings where read-only / all traffic sheds
                         (defaults: 64 / 256)
  -flushinterval=<n>     Flush chainstate every <n> connected blocks (default: 64)
"""


class ConfigError(Exception):
    pass


class Config:
    """Parsed arguments + config file, with typed accessors."""

    def __init__(self, argv: Optional[list[str]] = None):
        # name -> list of values; CLI wins over conf (soft-set semantics)
        self.args: dict[str, list[str]] = {}
        if argv:
            self.parse_args(argv)

    # -- parsing -------------------------------------------------------

    @staticmethod
    def _split(arg: str) -> tuple[str, str]:
        key, _, value = arg.partition("=")
        key = key.lstrip("-")
        if not _:
            value = "1"
        if key.startswith("no"):  # -nofoo => -foo=0  (InterpretNegatedOption)
            return key[2:], "0" if value == "1" else "1"
        return key, value

    def parse_args(self, argv: list[str]) -> None:
        """ParseParameters. Raises ConfigError on non-flag positionals."""
        for arg in argv:
            if not arg.startswith("-"):
                raise ConfigError(f"unexpected argument: {arg!r}")
            key, value = self._split(arg)
            self.args.setdefault(key, []).append(value)

    def read_config_file(self, path: Optional[str] = None) -> None:
        """ReadConfigFile — ini-style `name=value` lines, '#' comments.
        Values soft-set: the CLI keeps precedence."""
        if path is None:
            path = os.path.join(self.datadir_base, self.get("conf", "bitcoin.conf"))
        if not os.path.exists(path):
            return
        file_args: dict[str, list[str]] = {}
        with open(path) as f:
            for raw in f:
                line = raw.split("#", 1)[0].strip()
                if not line:
                    continue
                if "=" not in line:
                    raise ConfigError(f"parse error in {path}: {raw.strip()!r}")
                key, value = line.split("=", 1)
                file_args.setdefault(key.strip().lstrip("-"), []).append(value.strip())
        for key, values in file_args.items():
            if key not in self.args:
                self.args[key] = values

    # -- typed accessors (GetArg family) -------------------------------

    def get(self, name: str, default: str = "") -> str:
        values = self.args.get(name)
        return values[0] if values else default

    def get_multi(self, name: str) -> list[str]:
        return list(self.args.get(name, ()))

    def get_bool(self, name: str, default: bool = False) -> bool:
        values = self.args.get(name)
        if not values:
            return default
        return values[0] not in ("0", "false", "")

    def get_int(self, name: str, default: int = 0) -> int:
        values = self.args.get(name)
        if not values:
            return default
        try:
            return int(values[0])
        except ValueError:
            raise ConfigError(f"-{name}={values[0]!r}: not an integer") from None

    def has(self, name: str) -> bool:
        return name in self.args

    # -- derived settings ----------------------------------------------

    @property
    def network(self) -> str:
        if self.get_bool("regtest"):
            return "regtest"
        if self.get_bool("testnet"):
            return "test"
        return "main"

    @property
    def datadir_base(self) -> str:
        return os.path.expanduser(self.get("datadir", DEFAULT_DATADIR))

    @property
    def datadir(self) -> str:
        """Network subdirectory, as GetDataDir(fNetSpecific=true) lays out."""
        sub = {"main": "", "test": "testnet3", "regtest": "regtest"}[self.network]
        return os.path.join(self.datadir_base, sub) if sub else self.datadir_base

    def chain_params(self) -> ChainParams:
        """SelectParams + -assumevalid override (src/init.cpp AppInitMain)."""
        params = select_params(self.network)
        if self.has("assumevalid"):
            raw = self.get("assumevalid")
            av = None if raw in ("0", "") else hex_to_hash(raw)
            params = replace(params, assume_valid=av)
        if self.has("minimumchainwork"):
            params = replace(
                params, minimum_chain_work=int(self.get("minimumchainwork"), 16)
            )
        return params

    @property
    def tpu_backend(self) -> str:
        """Backend policy for ecdsa_batch / the mining sweep: the `--tpu`
        graft flag (SURVEY.md §6.6). Unset = 'auto' (use a device when one
        is present), -tpu=1 forces device, -tpu=0 forces CPU."""
        if not self.has("tpu"):
            return "auto"
        return "tpu" if self.get_bool("tpu") else "cpu"

    def rpc_port(self, params: ChainParams) -> int:
        return self.get_int("rpcport", params.rpc_port)

    def p2p_port(self, params: ChainParams) -> int:
        return self.get_int("port", params.default_port)
