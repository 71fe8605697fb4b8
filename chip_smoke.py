#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bitcoincashplus_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build   — compile csrc/w4_verify.cu with nvcc (sm_90a) from this
             checkout; print the build seconds and ptxas' report.
2. kernels — each CUDA entry at the shapes the main path gives it
             (w4_verify_bytes at B = 1024, 2048, 8192, 16384;
             w4_verify_planes at B = 32, 128) on seeded valid and invalid
             signatures, wrap lanes, q_inf lanes and crafted degenerate
             lanes; the kernel is held against its plain PyTorch version
             on the card (degen equal everywhere, ok equal on non-degen
             lanes) and the verdicts after the host re-check against the
             host oracle. Kernel and plain times, and the integer-op
             bound.
3. slice   — the block-validation main path at bench.py's reindex size:
             a 16,000-signature regtest chain from workload/sigchain.py,
             read back block by block through a ChainstateManager with
             BlockScriptVerifier(backend="device", kernel="w4") at
             pipeline depth 8; a small good tip and a tampered tip
             (submitblock shape); dispatch_packed(backend="device") on
             8190 of the chain's signatures (the native engine's slice
             width). Launch counts are zeroed just before and read just
             after, per entry and per shape. Then the same chain on the
             CPU engine: the coin digest and best block must match. Any
             shape the main path launched that phase 2 did not cover
             is then held against the plain version the same way.
4. report  — a JSON line of the kernels (times at the shape the main
             path launched most) with launches, errors, times and
             bounds; the validation wall time and sigs/s; the card's name
             and power limit; last, {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when torch.cuda.is_available() is
false or the port package is not importable.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CHAIN_SIGS = 16_000          # bench.py's reindex size
PACKED_LANES = 8190          # the native engine's dispatch slice
PIPELINE_DEPTH = 8
BYTES_SHAPES = (1024, 2048, 8192, 16384)  # 2048: the LanePacker's bucket
PLANES_SHAPES = (32, 128)
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


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return out.strip().splitlines()[0]


# ---- inputs -----------------------------------------------------------------

def signed_records(n: int, seed: int) -> list:
    """n seeded ECDSA SigCheckRecords over 32 keys, every 4th one invalid
    (message off by one), plus one crafted degenerate lane every 97 lanes:
    pubkey G and message hash e = r, so u1 == u2 and the first nonzero
    window adds jG to jG (H == 0). The degenerate signature is valid."""
    from bitcoincashplus_tpu_torch import native
    from bitcoincashplus_tpu_torch.crypto import secp256k1 as O
    from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord

    rng = random.Random(seed)
    keys = [rng.randrange(1, O.N) for _ in range(32)]
    pubs = [O.point_mul(d, O.G) for d in keys]
    sign = native.ecdsa_sign if native.available() else O.ecdsa_sign
    out = []
    for i in range(n):
        if i % 97 == 5:
            k = rng.randrange(1, O.N)
            r = O.point_mul(k, O.G)[0] % O.N
            s = pow(k, O.N - 2, O.N) * (2 * r) % O.N  # d = 1, e = r
            out.append(SigCheckRecord(O.G, r, s, r))
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
    """One entry at one shape: kernel vs plain on the card, verdicts after
    the host re-check vs the oracle, times and bound. (On a CPU device the
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

    ok_k, dg_k = wrapper(*tens)
    plain_ms, (ok_p, dg_p) = time_once(lambda: plain(*tens), dev)
    ok_k, dg_k = ok_k.cpu().numpy(), dg_k.cpu().numpy()
    ok_p, dg_p = ok_p.cpu().numpy(), dg_p.cpu().numpy()
    err = max(int(np.abs(ok_k.astype(int) - ok_p.astype(int))[~dg_k].max(
        initial=0)), int(np.abs(dg_k.astype(int) - dg_p.astype(int)).max()))
    if not np.array_equal(dg_k, dg_p):
        raise AssertionError(f"{entry} B={B}: degen planes differ at "
                             f"{np.nonzero(dg_k != dg_p)[0][:10]}")
    nd = ~dg_k
    if not np.array_equal(ok_k[nd], ok_p[nd]):
        raise AssertionError(f"{entry} B={B}: ok differs on non-degen lanes "
                             f"{np.nonzero((ok_k != ok_p) & nd)[0][:10]}")
    # verdicts after the host re-check of degen lanes, on the record lanes
    crafted = set(kinds["q_inf"]) | set(kinds["wrap_on"]) | \
        set(kinds["wrap_off"])
    oracle = host_oracle(recs)
    final = np.where(dg_k[:n], oracle, ok_k[:n])
    plain_lanes = np.array([i not in crafted for i in range(n)])
    if not np.array_equal(final[plain_lanes], oracle[plain_lanes]):
        raise AssertionError(f"{entry} B={B}: verdicts differ from the "
                             "oracle")
    if ok_k[kinds["q_inf"]].any() or dg_k[kinds["q_inf"]].any():
        raise AssertionError(f"{entry} B={B}: a q_inf lane reported")
    if ok_k[n:].any():
        raise AssertionError(f"{entry} B={B}: a padding lane reported")
    # degen lanes carry garbage by contract: the gate is read on the rest
    won = [i for i in kinds["wrap_on"] if not dg_k[i]]
    woff = [i for i in kinds["wrap_off"] if not dg_k[i]]
    if not np.array_equal(ok_k[won], oracle[won]) or ok_k[woff].any():
        raise AssertionError(f"{entry} B={B}: wrap gate wrong")
    n_degen = int(dg_k.sum())
    if n_degen < 1:
        raise AssertionError(f"{entry} B={B}: no degenerate lane flagged")

    if dev.type == "cuda":
        ms = time_cuda(lambda: wrapper(*tens), 20 if B <= 8192 else 10)
    else:
        ms = time_once(lambda: wrapper(*tens), dev)[0]
    if be:
        u1w = S._expand_nibble_windows(tens[0].cpu()).T.numpy()
        u2w = S._expand_nibble_windows(tens[1].cpu()).T.numpy()
        in_bytes = B * (6 * 32 + 2)
    else:
        u1w, u2w = arrays["u1"].T, arrays["u2"].T
        in_bytes = B * (2 * 64 * 4 + 4 * 20 * 4 + 2)
    imads = imad_count(u1w, u2w, arrays["q_inf"] != 0)
    ops_ms = imads / (SMS * IMAD_PER_SM_CLK * clock_hz) * 1e3
    bytes_ms = (in_bytes + 2 * B) / HBM_BYTES_S * 1e3
    return {"B": B, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "imads": imads, "max_abs_err": err, "degen_lanes": n_degen,
            "sigs_per_s": B / (ms / 1e3)}


def slice_phase(workdir: str, sigs: int = CHAIN_SIGS,
                packed_lanes: int = PACKED_LANES, **gen_kw) -> dict:
    """The main path at the reindex size (see the module docstring);
    ``gen_kw`` passes through to sigchain.generate."""
    import numpy as np

    from bitcoincashplus_tpu_torch import native
    from bitcoincashplus_tpu_torch.consensus.block import CBlock
    from bitcoincashplus_tpu_torch.ops import dispatch
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
    from bitcoincashplus_tpu_torch.ops import secp256k1 as S
    from bitcoincashplus_tpu_torch.validation.chain import BlockStatus
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
    cpu_packed = np.asarray(native.ecdsa_verify_batch_blobs(
        pub.tobytes(), rs.tobytes(), msg.tobytes(), len(msg)), bool)

    # ---- the main path, counts zeroed just before --------------------
    dispatch.reset()
    E.STATS.__init__()
    S.reset_launch_counts()
    t0 = time.monotonic()
    cs, dev = sigchain.validate_chain(workdir, "device", kernel="w4",
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
    packed = E.dispatch_packed(pub, rs, msg, rn, wrap,
                               backend="device").result()
    launches = dict(S.LAUNCHES)
    launch_shapes = sorted([name, B, n]
                           for (name, B), n in S.LAUNCH_SHAPES.items())
    stats = E.STATS.snapshot()
    healthy = dispatch.breaker("ecdsa").healthy()
    # ---- read just after ---------------------------------------------

    _cs_cpu, cpu = sigchain.validate_chain(workdir, "cpu", depth=1)
    checks = {
        "digest_equal": dev["digest"] == cpu["digest"],
        "best_equal": dev["best"] == cpu["best"],
        "tampered_rejected": bad_rejected and bad_device_false >= 1,
        "good_tip_accepted": good_accepted,
        "packed_equal_native": bool(np.array_equal(packed, cpu_packed)),
        "launches_bytes": launches["w4_verify_bytes"] > 0,
        "launches_planes": launches["w4_verify_planes"] > 0,
        "no_cpu_fallback": stats["cpu_fallback_sigs"] == 0,
        "no_fault_fallback": stats["fault_fallback_sigs"] == 0,
        "breaker_healthy": healthy,
    }
    return {"gen": {k: v for k, v in gen.items() if "tip" not in k},
            "device": dev, "cpu": {k: cpu[k] for k in ("digest", "best",
                                                      "wall_s")},
            "wall_s": wall, "sigs": gen["sigs"],
            "sigs_per_s": gen["sigs"] / wall, "launches": launches,
            "launch_shapes": launch_shapes,
            "stats": {k: stats[k] for k in (
                "dispatches", "sigs_verified", "cpu_fallback_sigs",
                "fault_fallback_sigs", "degenerate_rechecks",
                "reject_confirm_sigs", "buckets_used")},
            "packed_false": int((~packed).sum()), "checks": checks}


def dev_tip(summary: dict) -> bytes:
    return bytes.fromhex(summary["best"])


def main() -> int:
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
        from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
        from bitcoincashplus_tpu_torch.ops import secp256k1 as S
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable ({e})",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules or any(m.startswith("bitcoincashplus_tpu.")
                                   for m in sys.modules):
        print("chip_smoke: the JAX package was imported", file=sys.stderr)
        return 1
    E.set_device("cuda")
    t_all = time.monotonic()
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    log(f"card: {card}, max SM clock {clock_mhz:.0f} MHz, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.monotonic()
    S._kernel_lib()
    build_s = time.monotonic() - t0
    log(f"build: {build_s:.1f} s ({S.BUILD_INFO.get('command', 'cached')})")
    lines = S.BUILD_INFO.get("log", "").splitlines()
    for prev, line in zip([""] + lines, lines):
        if "Used" in line or ("spill" in line and "_kernel" in prev):
            log(f"ptxas: {line.strip()}")

    # 2. kernels, at the shapes the main path gives them
    shapes = {"w4_verify_bytes": BYTES_SHAPES,
              "w4_verify_planes": PLANES_SHAPES}
    seeds = {"w4_verify_bytes": 100, "w4_verify_planes": 200}
    cases = {name: [kernel_case(name, B, seeds[name] + i, clock_mhz * 1e6)
                    for i, B in enumerate(Bs)]
             for name, Bs in shapes.items()}

    # 3. the slice (the main path; launch counts zeroed just before)
    workdir = os.path.join(REPO, "build", "smoke_chain")
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        sl = slice_phase(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"slice: {json.dumps(sl, sort_keys=True)}")
    failed = [k for k, v in sl["checks"].items() if not v]
    if failed:
        raise AssertionError(f"slice checks failed: {failed}")
    # every shape the main path launched is held against the plain version
    path_shapes = {name: {} for name in S.LAUNCHES}
    for name, B, count in sl["launch_shapes"]:
        path_shapes[name][B] = count
        if all(r["B"] != B for r in cases[name]):
            cases[name].append(kernel_case(
                name, B, seeds[name] + len(cases[name]), clock_mhz * 1e6))
    for name, rows in cases.items():
        rows.sort(key=lambda r: r["B"])
        for r in rows:
            log(f"{name} B={r['B']}: kernel {r['ms']:.3f} ms, plain "
                f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), {r['sigs_per_s']:.0f} sigs/s, "
                f"{r['degen_lanes']} degen lane(s), err {r['max_abs_err']}, "
                f"{path_shapes[name].get(r['B'], 0)} main-path launch(es)")

    # 4. report: each kernel at the shape the main path launched most
    replaces = {
        "w4_verify_bytes": "bitcoincashplus_tpu/ops/secp256k1.py:912",
        "w4_verify_planes": "bitcoincashplus_tpu/ops/secp256k1.py:827",
    }
    kernels = []
    for name, rows in cases.items():
        counts = path_shapes[name]
        top = max(counts, key=lambda b: (counts[b], b))
        row = next(r for r in rows if r["B"] == top)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "bitcoincashplus_tpu_torch/csrc/w4_verify.cu",
            "replaces": replaces[name],
            "launches": sl["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "B": row["B"],
            "shapes": [{**{k: r[k] for k in ("B", "ms", "plain_ms",
                                             "bound_ms", "sigs_per_s")},
                        "launches": counts.get(r["B"], 0)} for r in rows],
        })
    log(f"validation: {sl['sigs']} sigs in {sl['wall_s']:.2f} s on the "
        f"device path = {sl['sigs_per_s']:.0f} sigs/s (pipeline depth "
        f"{PIPELINE_DEPTH}); total {time.monotonic() - t_all:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
