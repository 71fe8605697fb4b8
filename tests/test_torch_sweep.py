"""The port's SHA-256d nonce sweeps (bitcoincashplus_tpu_torch/ops/
sha256_sweep.py, pallas_sweep.py, miner.py) on the CPU device — the plain
PyTorch versions stand in for the CUDA kernels — against the JAX package.

Tolerance: exact equality everywhere (integer hashing).

Cost: under jax.jit the JAX sweeps take minutes of XLA compile on a CPU,
and the Pallas kernel in interpret mode does not finish one call at the
smallest shape within minutes. So the JAX host loops and loop programs
(sweep_header / sweep_jit, sweep_header_fast / sweep_fast_jit,
sweep_header_pallas) run eagerly under jax.disable_jit(), and their
per-tile hash functions (sweep_h7_hoisted, sweep_digest_hoisted — written
polymorphic over numpy and traced arrays) are evaluated on numpy arrays.
K11's kernel, pallas_sweep_jit, is replaced by its plain reference
sweep_fast_jit at a tile of sublanes * 128 nonces and min(n_tiles,
max_tiles) tiles — the same (found, nonce, tiles_done) contract — so
sweep_header_pallas's own host loop (which wraps past 2^32) is what is
compared. The per-nonce test runs the JAX sweep_h7 on jax arrays.
"""

import hashlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoincashplus_tpu.crypto.hashes import chunk2_round_state
from bitcoincashplus_tpu.crypto.hashes import header_midstate as jmidstate
from bitcoincashplus_tpu.ops import miner as jmi
from bitcoincashplus_tpu.ops import pallas_sweep as jps
from bitcoincashplus_tpu.ops import sha256_sweep as jsw
from bitcoincashplus_tpu.ops.sha256 import bytes_to_words_np as jwords
from bitcoincashplus_tpu_torch.ops import cuda_build
from bitcoincashplus_tpu_torch.ops import miner as MI
from bitcoincashplus_tpu_torch.ops import pallas_sweep as PS
from bitcoincashplus_tpu_torch.ops import sha256_sweep as SW

TILE = 1 << 10          # the exact and h7 entries' tile in this file
SUBLANES = TILE // 128  # the Pallas contract's tile: the same 1024 nonces
MAX_TILES = 2           # a small static grid: the host loop relaunches
EASY = 0x7FFFFF << (8 * 29)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain sweeps' tensors are small, and the
    suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    cuda_build.set_device("cpu")


def _np_pre(pre):
    """A hoisted template of jax 0-d arrays -> the same of numpy uint32."""
    if isinstance(pre, dict):
        return {k: _np_pre(v) for k, v in pre.items()}
    if isinstance(pre, (list, tuple)):
        return type(pre)(_np_pre(v) for v in pre)
    return np.uint32(np.asarray(pre))


def _numpy_eval(fn):
    def run(pre, nonces):
        out = fn(_np_pre(pre), np.asarray(nonces, dtype=np.uint32))
        if isinstance(out, list):
            return [jnp.asarray(x) for x in out]
        return jnp.asarray(out)
    return run


def _pallas_standin(midstate, tail, t7, start_nonce, n_tiles,
                    sublanes=jps.DEFAULT_SUBLANES, max_tiles=4096,
                    interpret=False):
    found, nonce, tiles = jsw.sweep_fast_jit(
        midstate, tail, t7, start_nonce,
        jnp.uint32(min(int(n_tiles), max_tiles)), tile=sublanes * jps.LANES)
    return found, jnp.where(found, nonce, jnp.uint32(0)), tiles


@pytest.fixture(scope="module")
def jax_eager():
    """The JAX package's sweeps run eagerly (module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsw, "sweep_h7_hoisted", _numpy_eval(jsw.sweep_h7_hoisted))
        mp.setattr(jmi, "sweep_digest_hoisted",
                   _numpy_eval(jmi.sweep_digest_hoisted))
        mp.setattr(jps, "pallas_sweep_jit", _pallas_standin)
        with jax.disable_jit():
            yield


def _hash(header: bytes, nonce: int) -> int:
    return int.from_bytes(hashlib.sha256(hashlib.sha256(
        header[:76] + nonce.to_bytes(4, "little")).digest()).digest(),
        "little")


def _parts(header: bytes):
    mid = np.array(jmidstate(header), dtype=np.uint32)
    return mid, jwords(np.frombuffer(header[64:76], dtype=np.uint8))


# ---- per nonce --------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 8])
def test_h7_and_digest_per_nonce_match_jax_and_hashlib(seed):
    rng = np.random.default_rng(seed)
    header = rng.integers(0, 256, size=80, dtype=np.uint8).tobytes()
    mid, tail = _parts(header)
    nonces = rng.integers(0, 2**32, size=48, dtype=np.uint32)
    pre = SW.hoist_template(mid, tail)
    tn = torch.from_numpy(nonces.astype(np.int64))
    h7 = SW.sweep_h7_hoisted(pre, tn).tolist()
    h8 = [x.tolist() for x in SW.sweep_digest_hoisted(pre, tn)]
    j7 = np.asarray(jsw.sweep_h7(list(mid), list(tail), jnp.asarray(nonces)))
    with jax.disable_jit():
        j8 = [np.asarray(x) for x in jsw.sweep_digest_hoisted(
            jsw.hoist_template(list(mid), list(tail)), jnp.asarray(nonces))]
    for i, n in enumerate(nonces):
        dig = hashlib.sha256(hashlib.sha256(
            header[:76] + int(n).to_bytes(4, "little")).digest()).digest()
        words = [int.from_bytes(dig[4 * j:4 * j + 4], "big") for j in range(8)]
        assert h7[i] == int(j7[i]) == words[7]
        assert [h8[j][i] for j in range(8)] == [int(j8[j][i])
                                                 for j in range(8)] == words


@pytest.mark.parametrize("seed", [21, 22])
def test_unhoisted_forms_match_the_jax_package_on_numpy(seed, monkeypatch):
    """header_sweep_digest (ops/sha256) and sweep_h7 (ops/sha256_sweep),
    the reference's unhoisted forms, bit-equal at 64 nonces to the JAX
    package's run eagerly on numpy (BCP_SHA_UNROLL=1: its unrolled
    compression, numpy arithmetic, no XLA program) and to hashlib."""
    from bitcoincashplus_tpu.ops import sha256 as jsha

    from bitcoincashplus_tpu_torch.ops import sha256 as SH

    monkeypatch.setenv("BCP_SHA_UNROLL", "1")
    rng = np.random.default_rng(seed)
    header = rng.integers(0, 256, size=80, dtype=np.uint8).tobytes()
    mid, tail = _parts(header)
    nonces = rng.integers(0, 2**32, size=64, dtype=np.uint32)
    nonces[:2] = (0, 2**32 - 1)
    tn = torch.from_numpy(nonces.astype(np.int64))
    ours8 = SH.header_sweep_digest([int(m) for m in mid],
                                   [int(t) for t in tail], tn)
    ours7 = SW.sweep_h7(mid, tail, tn)
    theirs8 = jsha.header_sweep_digest(list(mid), list(tail), nonces)
    theirs7 = jsw.sweep_h7(list(mid), list(tail), nonces)
    assert all(isinstance(x, np.ndarray) for x in theirs8 + [theirs7])
    assert [x.tolist() for x in ours8] == [
        np.asarray(x, dtype=np.int64).tolist() for x in theirs8]
    assert ours7.tolist() == np.asarray(theirs7, dtype=np.int64).tolist()
    for i, n in enumerate(nonces):
        dig = hashlib.sha256(hashlib.sha256(
            header[:76] + int(n).to_bytes(4, "little")).digest()).digest()
        words = [int.from_bytes(dig[4 * j:4 * j + 4], "big") for j in range(8)]
        assert [int(x[i]) for x in ours8] == words
        assert int(ours7[i]) == words[7]
    # the hoisted forms the sweeps run agree with the unhoisted ones
    pre = SW.hoist_template(mid, tail)
    assert [x.tolist() for x in SW.sweep_digest_hoisted(pre, tn)] == [
        x.tolist() for x in ours8]
    assert SW.sweep_h7_hoisted(pre, tn).tolist() == ours7.tolist()


def test_template_matches_the_jax_hoist_and_round_trips():
    rng = np.random.default_rng(11)
    for _ in range(4):
        header = rng.integers(0, 256, size=80, dtype=np.uint8).tobytes()
        mid, tail = _parts(header)
        ours = SW.hoist_template(mid, tail)
        theirs = jsw.hoist_template(list(mid), list(tail))
        assert tuple(ours["st3"]) == chunk2_round_state(
            jmidstate(header), header[64:76])
        for key in ("st3", "kw"):
            assert list(ours[key]) == [int(x) for x in theirs[key]]
        for key in ("c3t1", "t2_3"):
            assert ours[key] == int(theirs[key])
        for key in ("sc", "kwsc"):
            assert ours[key] == {i: int(v) for i, v in theirs[key].items()}
        back = SW.unpack_template(SW.template_tensor(mid, tail, "cpu"))
        assert [int(x) for x in back["st3"]] == list(ours["st3"])
        assert {i: int(v) for i, v in back["sc"].items()} == ours["sc"]
        assert {i: int(v) for i, v in back["kwsc"].items()} == ours["kwsc"]
        assert [int(x) for x in back["kw"]] == ours["kw"]


# ---- host loops against the JAX package -------------------------------------

def _case(name: str):
    """(header, target, start, max_nonces) of a named case, with its
    precondition checked by hashlib over the nonces it covers."""
    for seed in range(64):
        header = np.random.default_rng(100 + seed).integers(
            0, 256, size=80, dtype=np.uint8).tobytes()
        if name == "hit":
            # one hit, in the second tile
            hs = [_hash(header, n) for n in range(2 * TILE)]
            best = int(np.argmin([h >> 200 for h in hs]))
            if best >= TILE:
                return header, hs[best], 0, 2 * TILE
        elif name == "two_planted":
            # the two smallest hashes of three tiles, in different tiles:
            # both pass the target, and the lower nonce must win
            hs = [_hash(header, n) for n in range(3 * TILE)]
            a, b = sorted(np.argsort([h >> 200 for h in hs])[:2])
            if a // TILE != b // TILE and b // TILE == a // TILE + 1:
                return header, max(hs[a], hs[b]), 0, 3 * TILE
        elif name == "false_positive":
            # target = (the window's least hash) - 1: a limb-7 tie at that
            # nonce fails the full compare, is resumed past, and a real hit
            # follows later in the second tile
            hs = [_hash(header, n) for n in range(2 * TILE)]
            n0 = int(np.argmin([h >> 200 for h in hs[:TILE]]))
            target = hs[n0] - 1
            later = [n for n in range(n0 + 1, 2 * TILE) if hs[n] <= target]
            if n0 > 0 and later and later[0] >= TILE:
                return header, target, 0, 2 * TILE
        elif name == "no_hit":
            return header, 0, 5, 2 * TILE
        elif name == "top_of_space":
            # start 3 tiles below 2^32; the first hit lies past the wrap
            start = (1 << 32) - 3 * TILE
            top = [_hash(header, start + n) for n in range(3 * TILE)]
            low = [_hash(header, n) for n in range(2 * TILE)]
            target = min(low)
            if min(top) > target and low.index(target) >= TILE // 2:
                return header, target, start, 5 * TILE
    raise AssertionError(f"no seed gives case {name}")


CASES = ("hit", "two_planted", "false_positive", "no_hit", "top_of_space")


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in CASES}


def _loops():
    return {
        "exact": (lambda h, t, s, m: jmi.sweep_header(h, t, s, m, tile=TILE),
                  lambda h, t, s, m: MI.sweep_header(h, t, s, m, tile=TILE)),
        "h7": (lambda h, t, s, m: jsw.sweep_header_fast(h, t, s, m,
                                                        tile=TILE),
               lambda h, t, s, m: SW.sweep_header_fast(h, t, s, m,
                                                       tile=TILE)),
        "pallas": (lambda h, t, s, m: jps.sweep_header_pallas(
                       h, t, s, m, sublanes=SUBLANES, max_tiles=MAX_TILES),
                   lambda h, t, s, m: PS.sweep_header_pallas(
                       h, t, s, m, sublanes=SUBLANES, max_tiles=MAX_TILES)),
    }


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("loop", ["exact", "h7", "pallas"])
def test_host_loop_matches_jax(loop, case, cases, jax_eager):
    """(nonce, hashes) equal to the JAX package's host loop of the same
    entry: a hit, two planted hits in different tiles, a limb-7 tie that
    must be resumed past, no hit, and a start 3 tiles below 2^32 (where
    the exact and h7 loops stop at the boundary and the Pallas loop
    wraps)."""
    header, target, start, max_nonces = cases[case]
    ref_fn, port_fn = _loops()[loop]
    ref = ref_fn(header, target, start, max_nonces)
    got = port_fn(header, target, start, max_nonces)
    assert got == (None if ref[0] is None else int(ref[0]), int(ref[1]))
    if case == "top_of_space":
        # the two semantics, pinned: only the Pallas loop wraps to the hit
        assert (got[0] is not None) == (loop == "pallas")
    if got[0] is not None:
        assert _hash(header, got[0]) <= target
    if case in ("hit", "two_planted", "false_positive"):
        first = next(n for n in range(max_nonces)
                     if _hash(header, (start + n) & 0xFFFFFFFF) <= target)
        assert got[0] == first


@pytest.mark.parametrize("entry", ["exact", "h7", "pallas"])
def test_entries_match_jax_programs(entry, jax_eager):
    """One launch of each entry against the JAX program with the same
    contract: (found, tiles_done) and, when found, the nonce; two planted
    candidates in different tiles, and a launch that wraps past 2^32."""
    header, target, _s, _m = _case("two_planted")
    mid, tail = _parts(header)
    tmpl = SW.template_tensor(mid, tail, "cpu")
    t7 = int(target >> 224)
    for start, n_tiles in ((0, 3), ((1 << 32) - TILE, 3)):
        if entry == "exact":
            got = MI.sweep(tmpl, MI.target_tensor(target, "cpu"), start,
                           n_tiles, TILE).tolist()
            ref = jmi.sweep_jit(jnp.asarray(mid), jnp.asarray(tail),
                                jnp.asarray(jsw.target_to_limbs_np(target)),
                                jnp.uint32(start), jnp.uint32(n_tiles),
                                tile=TILE)
        elif entry == "h7":
            got = SW.sweep_fast(tmpl, t7, start, n_tiles, TILE).tolist()
            ref = jsw.sweep_fast_jit(jnp.asarray(mid), jnp.asarray(tail),
                                     jnp.uint32(t7), jnp.uint32(start),
                                     jnp.uint32(n_tiles), tile=TILE)
        else:
            got = PS.pallas_sweep(tmpl, t7, start, n_tiles, SUBLANES,
                                  MAX_TILES).tolist()
            ref = jps.pallas_sweep_jit(
                jnp.asarray(mid), jnp.asarray(tail), jnp.uint32(t7),
                jnp.uint32(start), jnp.uint32(n_tiles), sublanes=SUBLANES,
                max_tiles=MAX_TILES)
        found, nonce, tiles = (int(x) for x in ref)
        assert got[0] == found and got[2] == tiles
        assert got[1] == (nonce if found else 0)


# ---- the entries' rules -----------------------------------------------------

def test_entries_reject_bad_inputs_and_never_fall_back():
    header = bytes(range(80))
    tmpl = SW.header_template(header, "cpu")
    tgt = MI.target_tensor(EASY, "cpu")
    with pytest.raises(ValueError):
        SW.sweep_fast(tmpl[:63].contiguous(), 0, 0, 1, TILE)
    with pytest.raises(ValueError):
        SW.sweep_fast(tmpl.to(torch.int64), 0, 0, 1, TILE)
    with pytest.raises(ValueError):
        SW.sweep_fast(tmpl, 1 << 32, 0, 1, TILE)
    with pytest.raises(ValueError):
        MI.sweep(tmpl, tgt, -1, 1, TILE)
    with pytest.raises(ValueError):
        MI.sweep(tmpl, tgt[:7].contiguous(), 0, 1, TILE)
    with pytest.raises(ValueError):
        PS.pallas_sweep(tmpl, 0, 0, 1, sublanes=0)
    # a tensor on any device but the CPU launches the kernel or raises —
    # never the plain version
    meta = tmpl.to("meta")
    with pytest.raises(cuda_build.KernelUnavailable):
        SW.sweep_fast(meta, 0, 0, 1, TILE)
    with pytest.raises(cuda_build.KernelUnavailable):
        PS.pallas_sweep(meta, 0, 0, 1, SUBLANES, MAX_TILES)
    with pytest.raises(cuda_build.KernelUnavailable):
        MI.sweep(meta, tgt.to("meta"), 0, 1, TILE)
    assert SW.LAUNCHES == {"sweep_h7": 0, "sweep_h7_pallas": 0,
                           "sweep_exact": 0}


def test_cuda_selected_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    cuda_build.set_device("cuda")
    header = bytes(range(80))
    for fn in (MI.sweep_header, SW.sweep_header_fast,
               PS.sweep_header_pallas):
        with pytest.raises(cuda_build.KernelUnavailable):
            fn(header, EASY, 0, 1 << 12)


def test_the_cuda_source_matches_the_bindings():
    """csrc/sha256d_sweep.cu defines each C entry the wrappers bind, with
    as many parameters, and reads the template at the module's offsets."""
    import os

    src = open(os.path.join(cuda_build.CSRC_DIR, "sha256d_sweep.cu")).read()
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(entries) == set(SW.ENTRY_ARGS)
    for name, params in entries.items():
        assert len(params.split(",")) == len(SW.ENTRY_ARGS[name]), name
    offsets = dict(re.findall(r"(T_\w+) = (\d+)", src))
    for key in ("T_MID", "T_ST3", "T_C3T1", "T_T2_3", "T_KW", "T_SC",
                "T_KWSC"):
        assert int(offsets[key]) == getattr(SW, key), key
    assert int(offsets["T_WORDS"]) == SW.TEMPLATE_WORDS
