"""The port's live-traffic path — the signature service
(bitcoincashplus_tpu_torch/serving/sigservice.py) and mempool admission
through it — on the CPU, against the JAX package's service.

- A kernel that cannot be built or launched (KernelUnavailable) reaches
  the service's callers: result() raises, the service thread dies with
  it, its other in-flight lanes and the lanes queued behind them raise
  too, and a later submit (flushed inline on the caller) raises. It is
  never re-verified on the CPU.
- Any other flush error keeps the reference's caller-side CPU re-verify.
- ``backend="auto"`` with CUDA selected and no card raises from
  CPU_FLOOR records on; below it the CPU engine serves by design.
- 48 seeded records (good; bad s; wrong pubkey; tampered message) through
  the port's service on the CPU device with backend="device" (one flush,
  the plain GLV version) and through the JAX package's service
  (backend="cpu"): the same verdicts and the same sigcache inserts.
- A small storm (workload/txstorm) through a port Node, serviced and with
  -sigservice=off: the same mempool and the same reject reason for the
  tampered transaction.

No JAX GLV, w4 or MSM program is compiled: the JAX package's service runs
on its CPU engine. Tolerance: exact equality (verdicts and keys).
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from bitcoincashplus_tpu.script.interpreter import SigCheckRecord as JRecord
from bitcoincashplus_tpu.serving import SigService as JSigService
from bitcoincashplus_tpu.validation.sigcache import \
    SignatureCache as JSignatureCache
from bitcoincashplus_tpu_torch.crypto import secp256k1 as oracle
from bitcoincashplus_tpu_torch.mempool import MempoolError
from bitcoincashplus_tpu_torch.ops import cuda_build
from bitcoincashplus_tpu_torch.ops import dispatch as tdispatch
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord
from bitcoincashplus_tpu_torch.serving import SigService
from bitcoincashplus_tpu_torch.util import faults
from bitcoincashplus_tpu_torch.validation.sigcache import SignatureCache
from bitcoincashplus_tpu_torch.workload import txstorm

KU = cuda_build.KernelUnavailable


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain GLV version's tensors are small, and
    the suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    for k in ("BCP_FAULT_MODE", "BCP_FAULT_OPS", "BCP_ECDSA_KERNEL",
              "BCP_NO_DEVICE"):
        monkeypatch.delenv(k, raising=False)
    faults.INJECTOR.reload()
    tdispatch.reset()
    E.STATS.__init__()
    monkeypatch.setattr(E, "_KERNEL", None)
    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    cuda_build.set_device("cpu")
    yield
    faults.INJECTOR.reload()
    tdispatch.reset()


@pytest.fixture
def no_card():
    """CUDA selected on a host without a card (skips on one with a card:
    there the device leg would run)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    cuda_build.set_device("cuda")


def _service(**kw) -> SigService:
    return SigService(**kw).start()


def _dead(svc: SigService) -> bool:
    t = svc._thread
    if t is not None:
        t.join(timeout=10)
    return not svc.running()


# ---- F4: a kernel that cannot launch reaches the caller -----------------------

@pytest.mark.parametrize("how", ["no_card", "device_leg_raises"])
def test_kernel_unavailable_raises_to_the_caller_and_kills_the_thread(
        how, monkeypatch, request):
    """The repro of F4: the device leg raises KernelUnavailable (CUDA
    selected with no card, or _dispatch_device replaced by one that
    raises). result() raises it (before the repair: 16 x True from the
    CPU re-verify), the thread dies, and a later submit, flushed inline
    on the caller, raises too; nothing is verified on the CPU."""
    if how == "no_card":
        request.getfixturevalue("no_card")
    else:
        def broken(records, br, kernel=None):
            raise KU("the ecdsa device leg: no kernel library")

        monkeypatch.setattr(E, "_dispatch_device", broken)
    recs = txstorm.records(16, 1)
    svc = _service(backend="device")
    try:
        with pytest.raises(KU):
            svc.submit(recs).result()
        assert _dead(svc)
        assert svc.stats["flush_errors"] == 1
        with pytest.raises(KU):
            svc.submit(txstorm.records(2, 2))
        assert svc.stats["flush_errors"] == 2
    finally:
        svc.stop()
    assert E.STATS.cpu_fallback_sigs == 0
    assert E.STATS.fault_fallback_sigs == 0


class _Parked:
    """A dispatch handle whose verdict wait blocks until ``go`` is set,
    then raises ``err``."""

    def __init__(self, go: threading.Event, err: BaseException):
        self.go, self.err = go, err

    def result(self):
        assert self.go.wait(10)
        raise self.err


def test_kernel_unavailable_reaches_every_in_flight_flush(monkeypatch):
    """Two flushes in flight (buffers=2): the first one's settle raises
    KernelUnavailable; the death handler gives the second one's lanes the
    same error, so both waiters raise, and no lane is re-verified."""
    go, both = threading.Event(), threading.Event()
    err = KU("the GLV device-split kernel: launch failed")
    dispatched = []

    def parked(records, backend="auto", kernel=None):
        dispatched.append(len(records))
        if len(dispatched) == 1:
            assert both.wait(10)  # the second flush is pending
        return _Parked(go, err)

    monkeypatch.setattr(E, "dispatch_batch", parked)
    svc = _service(backend="auto", lanes=2, deadline_ms=60_000, buffers=2)
    try:
        first = svc.submit(txstorm.records(2, 3))
        second = svc.submit(txstorm.records(2, 4))
        both.set()
        for _ in range(1000):
            if len(dispatched) == 2:
                break
            threading.Event().wait(0.01)
        assert dispatched == [2, 2]
        go.set()
        for fut in (first, second):
            with pytest.raises(KU) as got:
                fut.result(timeout=10)
            assert got.value is err
        assert _dead(svc)
    finally:
        go.set()
        both.set()
        svc.stop()
    assert E.STATS.cpu_fallback_sigs == 0


def test_kernel_unavailable_reaches_the_lanes_queued_behind_it(monkeypatch):
    """Both slots in flight (buffers=2) and a third transaction queued
    behind them, its waiter already parked in result() while the thread
    lives. The first settle raises KernelUnavailable: the death handler
    gives the queued lanes the same error, so that waiter raises at once,
    instead of sitting out its timeout and re-verifying on the CPU; the
    queued lanes are never dispatched."""
    go, both = threading.Event(), threading.Event()
    err = KU("the GLV device-split kernel: launch failed")
    dispatched = []

    def parked(records, backend="auto", kernel=None):
        dispatched.append(len(records))
        if len(dispatched) == 1:
            assert both.wait(10)
        return _Parked(go, err)

    monkeypatch.setattr(E, "dispatch_batch", parked)
    svc = _service(backend="auto", lanes=2, deadline_ms=60_000, buffers=2)
    got = {}

    def wait_third(fut):
        t0 = time.monotonic()
        try:
            got["verdicts"] = fut.result(timeout=20)
        except KU as e:
            got["err"] = e
        got["seconds"] = time.monotonic() - t0

    try:
        first = svc.submit(txstorm.records(2, 3))
        second = svc.submit(txstorm.records(2, 4))
        both.set()
        for _ in range(1000):
            if len(dispatched) == 2:
                break
            time.sleep(0.01)
        assert dispatched == [2, 2]
        third = svc.submit(txstorm.records(2, 5))
        waiter = threading.Thread(target=wait_third, args=(third,))
        waiter.start()
        time.sleep(0.2)  # the waiter has kicked and sits on the condvar
        assert svc.running() and len(svc._pending) == 2
        go.set()
        for fut in (first, second):
            with pytest.raises(KU):
                fut.result(timeout=10)
        waiter.join(30)
        assert not waiter.is_alive()
        assert got.get("err") is err, got
        assert got["seconds"] < 10
        assert _dead(svc)
        assert dispatched == [2, 2] and not svc._pending
    finally:
        go.set()
        both.set()
        svc.stop()
    assert E.STATS.cpu_fallback_sigs == 0
    assert svc.stats["timeouts"] == 0


def test_a_transient_flush_error_degrades_to_caller_cpu(monkeypatch):
    """The reference's test_flush_error_degrades_to_caller_cpu on the
    port: a ValueError in the first flush resolves its lanes to an error,
    result() re-verifies them on the CPU (the verdicts survive: never
    dropped, never fabricated), and the service keeps running."""
    calls = {"n": 0}
    real = E.dispatch_batch

    def boom(records, backend="auto", kernel=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("injected flush failure")
        return real(records, backend=backend, kernel=kernel)

    monkeypatch.setattr(E, "dispatch_batch", boom)
    good, bad = txstorm.records(2, 5, bad_every=2)
    svc = _service(backend="cpu")
    try:
        fut = svc.submit([good, bad])
        assert fut.result().tolist() == [True, False]
        assert svc.stats["flush_errors"] == 1
        assert svc.running()  # a non-programming error is survivable
    finally:
        svc.stop()


# ---- F5: "auto" with CUDA selected and no card --------------------------------

def test_auto_without_a_card_raises_from_cpu_floor_on(no_card):
    """The repro of F5 through the service and verify_batch: 16 good
    records under backend="auto" raise KernelUnavailable (before the
    repair: 16 x True on the host oracle); under CPU_FLOOR they stay on
    the CPU engine by the reference's design."""
    assert E._device_available()
    recs = txstorm.records(16, 6)
    with pytest.raises(KU):
        E.verify_batch(recs[:E.CPU_FLOOR], backend="auto")
    svc = _service(backend="auto")
    try:
        with pytest.raises(KU):
            svc.submit(recs).result()
        assert _dead(svc)
    finally:
        svc.stop()
    assert E.STATS.cpu_fallback_sigs == 0
    few = recs[:E.CPU_FLOOR - 1]
    assert E.verify_batch(few, backend="auto").all()
    assert E.STATS.cpu_fallback_sigs == len(few)


# ---- against the JAX package --------------------------------------------------

def _mixed_records(seed: int, n: int = 48) -> list:
    """Port records of four kinds in turn: good, s + 1, another key's
    pubkey, the message + 1 (only the first kind verifies)."""
    recs = txstorm.records(n, seed)
    out = []
    for i, r in enumerate(recs):
        kind = i % 4
        if kind == 1:
            r = SigCheckRecord(r.pubkey, r.r, (r.s + 1) % oracle.N,
                               r.msg_hash)
        elif kind == 2:
            r = SigCheckRecord(recs[(i + 1) % n].pubkey, r.r, r.s,
                               r.msg_hash)
        elif kind == 3:
            r = SigCheckRecord(r.pubkey, r.r, r.s, (r.msg_hash + 1) % oracle.N)
        out.append(r)
    return out


def test_service_matches_the_jax_package_service():
    """48 seeded records, 2 a transaction, through the port's service on
    the CPU device with backend="device" (lanes=48: one full flush of the
    plain GLV version) and through the JAX package's service
    (backend="cpu"): equal verdicts, and equal sigcache inserts (the
    verified records' keys, inserted at settle)."""
    ours = _mixed_records(7)
    theirs = [JRecord(r.pubkey, r.r, r.s, r.msg_hash) for r in ours]
    cache, jcache = SignatureCache(), JSignatureCache()
    svc = _service(backend="device", lanes=len(ours), deadline_ms=60_000,
                   sigcache=cache)
    try:
        futs = [svc.submit(ours[i:i + 2]) for i in range(0, len(ours), 2)]
        got = np.concatenate([f.result() for f in futs])
        stats = dict(svc.stats)
    finally:
        svc.stop()
    jsvc = JSigService(backend="cpu", sigcache=jcache).start()
    try:
        jfuts = [jsvc.submit(theirs[i:i + 2])
                 for i in range(0, len(theirs), 2)]
        want = np.concatenate([f.result() for f in jfuts])
    finally:
        jsvc.stop()
    assert got.tolist() == want.tolist()
    assert got.tolist() == [i % 4 == 0 for i in range(len(ours))]
    assert stats["dispatches"] == 1 and stats["flush_full"] == 1
    assert E.STATS.glv_dev_dispatches == 1
    assert E.STATS.cpu_fallback_sigs == 0
    assert set(cache._set) == set(jcache._set)
    assert cache.inserts == jcache.inserts == int(got.sum())


@pytest.fixture(scope="module")
def storm_chain(tmp_path_factory):
    """A sigchain chain with the fan-out's outputs left (txstorm's
    storm_chain), and a storm over 64 of them: 6 parent -> child chains,
    2 Schnorr transactions, the tampered one, 23 independent (38 in all)."""
    d = str(tmp_path_factory.mktemp("storm") / "chain")
    txstorm.storm_chain(d)
    outs = txstorm.spendable(d)
    return d, txstorm.storm(outs[:64], n_chains=6, n_schnorr=2, seed=11)


def _node(datadir: str, **flags):
    from bitcoincashplus_tpu_torch.node.config import Config
    from bitcoincashplus_tpu_torch.node.node import Node

    cfg = Config()
    cfg.args.update(datadir=[datadir], regtest=["1"])
    for k, v in flags.items():
        cfg.args[k] = [str(v)]
    return Node(config=cfg)


def _feed(node, txs: list, threads: int, rejects: dict) -> None:
    """Node.accept_to_mempool from ``threads`` threads, each under
    cs_main (the RPC and P2P callers' hold); rejects by txid."""
    it = iter(list(txs))
    lock = threading.Lock()

    def work():
        while True:
            with lock:
                tx = next(it, None)
            if tx is None:
                return
            try:
                with node.cs_main:
                    node.accept_to_mempool(tx)
            except MempoolError as e:
                rejects[tx.txid_hex] = e.reason

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(60)
        assert not t.is_alive()


def test_serviced_node_admits_the_storm_as_the_unserviced_one(storm_chain):
    """The storm through a port Node on the CPU device, serviced (the
    default -sigservice=on) and with -sigservice=off -tpu=0: the first
    wave from 8 threads, the second (the chains' children) from 16, then
    the tampered and the Schnorr transactions. The same mempool, the
    tampered transaction rejected with mandatory-script-verify-flag-failed
    on both, and the serviced node's signatures through its service."""
    chain, st = storm_chain
    pools, rejected = {}, {}
    for name, flags in (("serviced", {}),
                        ("control", {"sigservice": "off", "tpu": "0"})):
        d = f"{chain}_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(chain, d)
        node = _node(d, **flags)
        try:
            assert (node.sigservice is not None) == (name == "serviced")
            rejects: dict = {}
            _feed(node, st["first"], 8, rejects)
            _feed(node, st["second"], 16, rejects)
            _feed(node, [st["tampered"]] + st["schnorr"], 2, rejects)
            pools[name] = set(node.mempool.entries)
            rejected[name] = rejects
            if node.sigservice is not None:
                snap = node.sigservice.snapshot()
                assert snap["flush_errors"] == 0 and snap["running"]
                assert snap["lanes_enqueued"] == 2 * (
                    len(st["first"]) + len(st["second"]) + 1
                    + len(st["schnorr"]))
        finally:
            node.close()
            shutil.rmtree(d, ignore_errors=True)
    txs = st["first"] + st["second"] + st["schnorr"]
    assert pools["serviced"] == pools["control"] == {tx.txid for tx in txs}
    want = {st["tampered"].txid_hex: "mandatory-script-verify-flag-failed"}
    assert rejected["serviced"] == rejected["control"] == want
    assert os.path.isdir(chain)
