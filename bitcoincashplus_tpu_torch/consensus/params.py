"""Chain parameters — main / testnet / regtest.

Reference: src/chainparams.cpp (CMainParams, CTestNetParams, CRegTestParams,
SelectParams), src/consensus/params.h (Consensus::Params),
src/chainparamsbase.cpp (ports/datadirs). Typed dataclasses replace the
string-keyed reference structs (SURVEY.md §6.6 decision) while preserving the
flag-compatible selection surface (-regtest/-testnet).

Genesis blocks are CONSTRUCTED here exactly as CreateGenesisBlock
(src/chainparams.cpp:~20) does and self-checked against the known mainnet
hash in tests — our strongest offline consensus anchor (SURVEY.md §8.5.3).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

from .block import CBlock, CBlockHeader
from .merkle import compute_merkle_root
from .serialize import hex_to_hash
from .tx import COIN, COutPoint, CTransaction, CTxIn, CTxOut
from .versionbits import NO_TIMEOUT, VBDeployment


@dataclass(frozen=True)
class Consensus:
    """Consensus::Params (src/consensus/params.h)."""

    pow_limit: int
    pow_target_timespan: int = 14 * 24 * 60 * 60  # two weeks
    pow_target_spacing: int = 10 * 60
    pow_allow_min_difficulty_blocks: bool = False
    pow_no_retargeting: bool = False
    subsidy_halving_interval: int = 210_000
    coinbase_maturity: int = 100  # COINBASE_MATURITY (src/consensus/consensus.h)
    bip34_height: int = 0  # height-in-coinbase activation
    bip16_time: int = 1333238400  # P2SH switch time (nBIP16SwitchTime)
    bip65_height: int = -1  # CHECKLOCKTIMEVERIFY (-1 = never)
    bip66_height: int = -1  # strict DER
    csv_height: int = -1  # BIP68/112/113 CHECKSEQUENCEVERIFY bundle
    # BCH-family deltas [fork-delta, hedged — SURVEY.md §0]:
    uahf_height: int = -1  # SIGHASH_FORKID activation (-1 = never)
    use_cash_daa: bool = False
    # cw-144 DAA activation height (BCH Nov-2017 rules); below it the
    # EDA applies while use_cash_daa is set. -1 = EDA era forever.
    daa_height: int = -1
    # BIP9 versionbits (src/consensus/params.h nRuleChangeActivationThreshold
    # / nMinerConfirmationWindow / vDeployments) — see consensus/versionbits.py
    rule_change_activation_threshold: int = 1916  # 95% of 2016
    miner_confirmation_window: int = 2016
    deployments: tuple = ()

    @property
    def difficulty_adjustment_interval(self) -> int:
        return self.pow_target_timespan // self.pow_target_spacing


@dataclass(frozen=True)
class ChainParams:
    """CChainParams (src/chainparams.h)."""

    network: str
    consensus: Consensus
    genesis: CBlock
    # P2P wire netmagic (pchMessageStart) — fork-specific values would differ;
    # using the lineage defaults [fork-delta, hedged].
    netmagic: bytes = b"\xf9\xbe\xb4\xd9"
    default_port: int = 8333
    rpc_port: int = 8332
    # base58 version bytes (src/chainparams.cpp base58Prefixes)
    pubkey_addr_prefix: int = 0x00
    script_addr_prefix: int = 0x05
    secret_key_prefix: int = 0x80
    # checkpoint map height -> block hash (wire order) — checkpointData
    checkpoints: dict = field(default_factory=dict)
    # assumevalid: skip script checks at/below this block (defaultAssumeValid)
    assume_valid: bytes | None = None
    minimum_chain_work: int = 0
    require_standard: bool = True
    max_block_size: int = 1_000_000  # MAX_BLOCK_BASE_SIZE; BCH forks raise it
    max_block_sigops: int = 20_000

    @property
    def genesis_hash(self) -> bytes:
        return self.genesis.get_hash()


GENESIS_TIMESTAMP_TEXT = (
    b"The Times 03/Jan/2009 Chancellor on brink of second bailout for banks"
)
GENESIS_OUTPUT_PUBKEY = bytes.fromhex(
    "04678afdb0fe5548271967f1a67130b7105cd6a828e03909a67962e0ea1f61deb6"
    "49f6bc3f4cef38c4f35504e51ec112de5c384df7ba0b8d578a4c702b6bf11d5f"
)


def create_genesis_block(time: int, nonce: int, bits: int, version: int, reward: int) -> CBlock:
    """CreateGenesisBlock (src/chainparams.cpp:~20): coinbase scriptSig pushes
    (486604799, CScriptNum(4), timestamp text); output pays the Satoshi pubkey."""
    # scriptSig: push <04 bits LE-trimmed> = 0x04ffff001d, push 0x01 0x04, push text
    script_sig = (
        bytes([4]) + (486604799).to_bytes(4, "little")
        + bytes([1]) + bytes([4])
        + bytes([len(GENESIS_TIMESTAMP_TEXT)]) + GENESIS_TIMESTAMP_TEXT
    )
    script_pubkey = bytes([len(GENESIS_OUTPUT_PUBKEY)]) + GENESIS_OUTPUT_PUBKEY + b"\xac"  # OP_CHECKSIG
    coinbase = CTransaction(
        version=1,
        vin=(CTxIn(COutPoint(), script_sig, 0xFFFFFFFF),),
        vout=(CTxOut(reward, script_pubkey),),
        locktime=0,
    )
    root, _ = compute_merkle_root([coinbase.txid])
    header = CBlockHeader(
        version=version,
        hash_prev_block=b"\x00" * 32,
        hash_merkle_root=root,
        time=time,
        bits=bits,
        nonce=nonce,
    )
    return CBlock(header, (coinbase,))


@lru_cache(maxsize=None)
def main_params() -> ChainParams:
    """CMainParams (src/chainparams.cpp:~60)."""
    consensus = Consensus(
        pow_limit=0x00000000FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF,
        bip34_height=227_931,
        bip65_height=388_381,  # v4 blocks (BIP65 deployment height)
        bip66_height=363_725,  # v3 blocks (BIP66)
        csv_height=419_328,  # CSV softfork activation
        uahf_height=478_559,  # [fork-delta, hedged] BCH-family split height
        use_cash_daa=False,  # per-run via -cashdaa/-daaheight (node/config)
        deployments=(
            # vDeployments[DEPLOYMENT_TESTDUMMY] (chainparams.cpp)
            VBDeployment("testdummy", 28, 1199145601, 1230767999),
            # DEPLOYMENT_CSV: the BIP9 run that activated at csv_height
            VBDeployment("csv", 0, 1462060800, 1493596800),
        ),
    )
    genesis = create_genesis_block(1231006505, 2083236893, 0x1D00FFFF, 1, 50 * COIN)
    return ChainParams(
        network="main",
        consensus=consensus,
        genesis=genesis,
        netmagic=b"\xf9\xbe\xb4\xd9",
        default_port=8333,
        rpc_port=8332,
        checkpoints={
            11_111: hex_to_hash("0000000069e244f73d78e8fd29ba2fd2ed618bd6fa2ee92559f542fdb26e7c1d"),
            105_000: hex_to_hash("00000000000291ce28027faea320c8d2b054b2e0fe44a773f3eefb151d6bdc97"),
            134_444: hex_to_hash("00000000000005b12ffd4cd315cd34ffd4a594f430ac814c91184a0d42d2b0fe"),
        },
        max_block_size=8_000_000,  # [fork-delta, hedged] big-block fork
    )


@lru_cache(maxsize=None)
def testnet_params() -> ChainParams:
    """CTestNetParams (src/chainparams.cpp:~180)."""
    consensus = Consensus(
        pow_limit=0x00000000FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF,
        pow_allow_min_difficulty_blocks=True,
        bip34_height=21_111,
        bip65_height=581_885,
        bip66_height=330_776,
        csv_height=770_112,
    )
    genesis = create_genesis_block(1296688602, 414098458, 0x1D00FFFF, 1, 50 * COIN)
    return ChainParams(
        network="test",
        consensus=consensus,
        genesis=genesis,
        netmagic=b"\x0b\x11\x09\x07",
        default_port=18333,
        rpc_port=18332,
        pubkey_addr_prefix=0x6F,
        script_addr_prefix=0xC4,
        secret_key_prefix=0xEF,
        require_standard=False,
    )


@lru_cache(maxsize=None)
def regtest_params() -> ChainParams:
    """CRegTestParams (src/chainparams.cpp:~280) — the universal fake backend:
    trivially low difficulty so tests mine instantly (SURVEY.md §5.1)."""
    consensus = Consensus(
        pow_limit=0x7FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF,
        pow_allow_min_difficulty_blocks=True,
        pow_no_retargeting=True,
        subsidy_halving_interval=150,
        bip34_height=0,
        bip16_time=0,  # P2SH always on (regtest, like the reference)
        bip65_height=0,
        bip66_height=0,
        csv_height=0,
        uahf_height=0,
        rule_change_activation_threshold=108,  # 75% of 144 (regtest)
        miner_confirmation_window=144,
        deployments=(
            VBDeployment("testdummy", 28, 0, NO_TIMEOUT),
        ),
    )
    genesis = create_genesis_block(1296688602, 2, 0x207FFFFF, 1, 50 * COIN)
    return ChainParams(
        network="regtest",
        consensus=consensus,
        genesis=genesis,
        netmagic=b"\xfa\xbf\xb5\xda",
        default_port=18444,
        rpc_port=18443,
        pubkey_addr_prefix=0x6F,
        script_addr_prefix=0xC4,
        secret_key_prefix=0xEF,
        require_standard=False,
    )


_NETWORKS = {
    "main": main_params,
    "test": testnet_params,
    "testnet": testnet_params,
    "regtest": regtest_params,
}


def select_params(network: str) -> ChainParams:
    """SelectParams (src/chainparams.cpp:~330)."""
    try:
        return _NETWORKS[network]()
    except KeyError:
        raise ValueError(f"unknown network {network!r}") from None


def get_block_subsidy(height: int, consensus: Consensus) -> int:
    """GetBlockSubsidy (src/validation.cpp:~1160): 50-coin base, halving every
    subsidy_halving_interval, zero after 64 halvings."""
    halvings = height // consensus.subsidy_halving_interval
    if halvings >= 64:
        return 0
    return (50 * COIN) >> halvings
