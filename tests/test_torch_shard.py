"""The port's sharded signature path (parallel/mesh.py and
parallel/sig_shard.py; K13) on the CPU: the device layouts under both
switches, and ``verify_batch_sharded`` — one launch of an already ported
kernel a shard (its plain version here, the tensors lying on the CPU),
the planes folded on the host — at widths 1 and 2 under the default GLV
device split and under w4, the GLV host-split route at width 2, and the
reference's dryrun at width 8.

Verdicts are held against the oracle (crypto/secp256k1.py), the unsharded
dispatch (ops/ecdsa_batch.dispatch_batch) on the same records, and the
reference's layout rules (its mesh's device count under its test
configuration, its ValueError). No JAX verify program is compiled: the
reference's sharded programs cost minutes of XLA compile on the CPU.
Everything compared is a verdict, so every comparison is exact.
"""

import random

import numpy as np
import pytest
import torch

from bitcoincashplus_tpu.parallel import mesh as ref_mesh
from bitcoincashplus_tpu_torch.crypto import secp256k1 as oracle
from bitcoincashplus_tpu_torch.ops import cuda_build
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
from bitcoincashplus_tpu_torch.ops import secp256k1 as S
from bitcoincashplus_tpu_torch.parallel import mesh, sig_shard
from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord

N = oracle.N


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    for k in ("BCP_FAULT_MODE", "BCP_FAULT_OPS", "BCP_ECDSA_KERNEL"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(E, "_KERNEL", None)
    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    cuda_build.set_device("cpu")
    yield


def _record(u1: int, u2: int, q: int) -> SigCheckRecord:
    """A valid signature with chosen verify scalars: R = u1 G + u2 Q,
    Q = q G, r = R.x mod n, s = r / u2, e = u1 s."""
    Q = oracle.point_mul(q, oracle.G)
    R = oracle.point_add(oracle.point_mul(u1, oracle.G),
                         oracle.point_mul(u2, Q))
    r = R[0] % N
    s = r * pow(u2, N - 2, N) % N
    return SigCheckRecord(Q, r, s, u1 * s % N)


def corpus(seed: int = 1013) -> list:
    """13 records (not a multiple of any width above 1): random valid
    signatures, lambda-boundary scalars, two forged twins, a GLV-degenerate
    lane (Q = G, u1 = u2 = 5: the ladder leaves 5G and the comb's first
    digit adds 5G), a bogus wrap claim (r = 5) and an out-of-range r = 0
    (a q_inf lane)."""
    rng = random.Random(seed)
    recs = []
    for _ in range(6):
        d, e = rng.randrange(1, N), rng.randrange(N)
        r, s = oracle.ecdsa_sign(d, e)
        recs.append(SigCheckRecord(oracle.point_mul(d, oracle.G), r, s, e))
    recs.append(_record(rng.randrange(N), S.LAMBDA, rng.randrange(1, N)))
    recs.append(_record(N - 1, S.LAMBDA + 1, rng.randrange(1, N)))
    recs.append(_record(5, 5, 1))
    for good in recs[0], recs[3]:
        recs.append(SigCheckRecord(good.pubkey, good.r, good.s,
                                   (good.msg_hash + 1) % N))
    recs.append(SigCheckRecord(recs[1].pubkey, 5, recs[1].s,
                               recs[1].msg_hash))
    recs.append(SigCheckRecord(recs[2].pubkey, 0, recs[2].s,
                               recs[2].msg_hash))
    return recs


@pytest.fixture(scope="module")
def records():
    recs = corpus()
    expect = [oracle.ecdsa_verify(r.pubkey, r.r, r.s, r.msg_hash)
              for r in recs]
    assert len(recs) == 13 and 0 < expect.count(False) < len(recs)
    return recs, expect


# ---- layouts ----------------------------------------------------------------

def test_cpu_layout_is_the_reference_virtual_mesh():
    """Under the CPU switch the layout is the CPU repeated, as many as the
    reference's virtual mesh has devices under its tests (8)."""
    devs = mesh.local_devices()
    assert devs == [torch.device("cpu")] * mesh.CPU_DEVICES
    assert len(devs) == len(ref_mesh.local_devices()) == mesh.device_count()
    assert mesh.chip_mesh() == devs
    assert mesh.chip_mesh(3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        mesh.chip_mesh(9)


def test_cuda_layout_is_every_card_and_no_more(monkeypatch):
    """Under the CUDA switch, cuda:0 .. cuda:{count - 1}; a wider layout
    raises the reference's ValueError."""
    cuda_build.set_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.chip_mesh() == [torch.device("cuda", 0),
                                torch.device("cuda", 1)]
    assert mesh.chip_mesh(1) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        mesh.chip_mesh(3)
    with pytest.raises(ValueError):
        sig_shard.verify_batch_sharded(corpus()[:2], 3)


def test_layout_takes_a_given_device_list_of_the_width():
    two = [torch.device("cpu")] * 2
    assert mesh.layout(2, ["cpu", "cpu"]) == two
    assert mesh.layout(None, two) == two
    assert mesh.layout(4, None) == [torch.device("cpu")] * 4
    for n, devs in ((3, two), (1, [])):
        with pytest.raises(ValueError):
            mesh.layout(n, devs)


def test_without_a_card_the_cuda_switch_raises(monkeypatch, records):
    """No card and the CUDA switch: the layout and every sharded entry
    raise KernelUnavailable — nothing falls back to the CPU."""
    from bitcoincashplus_tpu_torch.parallel import nonce_shard

    cuda_build.set_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recs, _ = records
    with pytest.raises(cuda_build.KernelUnavailable):
        mesh.local_devices()
    with pytest.raises(cuda_build.KernelUnavailable):
        sig_shard.verify_batch_sharded(recs, 1)
    with pytest.raises(cuda_build.KernelUnavailable):
        sig_shard.msm_is_infinity_sharded([(oracle.G[0], oracle.G[1], 1)], 1)
    with pytest.raises(cuda_build.KernelUnavailable):
        nonce_shard.sweep_header_sharded(bytes(80), 1 << 255, n_chips=1)


# ---- the sharded verify -----------------------------------------------------

@pytest.fixture(scope="module")
def unsharded():
    """The unsharded dispatch's verdicts on the corpus, per kernel."""
    recs = corpus()
    before = cuda_build.device()
    cuda_build.set_device("cpu")
    try:
        return {k: np.asarray(E.dispatch_batch(recs, backend="device",
                                               kernel=k).result())
                for k in ("glv", "w4")}
    finally:
        cuda_build.set_device(before)


@pytest.mark.parametrize("kernel,width", [("glv", 1), ("glv", 2),
                                          ("w4", 1), ("w4", 2)])
def test_verify_batch_sharded_matches_the_oracle_and_the_unsharded_dispatch(
        monkeypatch, records, unsharded, kernel, width):
    """One launch a shard (each shard its own 1024-lane bucket), the
    verdicts after the host re-check of degenerate lanes equal to the
    oracle's and the unsharded dispatch's; under GLV the crafted lane is
    re-checked on the host."""
    recs, expect = records
    calls = []
    name = {"glv": "ecdsa_verify_batch_glv_dev",
            "w4": "ecdsa_verify_batch_pallas_w4_bytes"}[kernel]
    real = getattr(S, name)

    def counted(*ts):
        calls.append(ts[0].shape[0])
        return real(*ts)

    monkeypatch.setattr(S, name, counted)
    rechecks = E.STATS.degenerate_rechecks
    got = sig_shard.verify_batch_sharded(recs, width, kernel=kernel)
    assert got.dtype == bool and got.tolist() == expect
    assert got.tolist() == unsharded[kernel].tolist()
    assert calls == [1024] * width
    if kernel == "glv":
        assert E.STATS.degenerate_rechecks > rechecks


def test_the_host_split_route_at_width_2(records):
    """The GLV verify from the host split (K7), reached through the
    shard-level function: each shard's planes equal the unsharded
    wrapper's on its rows, the fold's failure count is the reference's,
    and the verdicts after the re-check equal the oracle's."""
    recs, expect = records
    n = len(recs)
    arrays = E.pack_records_glv(recs, 2048)
    ok, degen, fails = sig_shard._sharded_glv(*arrays,
                                              devices=mesh.chip_mesh(2))
    assert ok.shape == degen.shape == (2048,)
    qinf = np.asarray(arrays[9])
    assert fails == int(np.sum((~ok | degen) & (qinf == 0)))
    assert fails == sum(1 for i in range(n)
                        if not qinf[i] and (degen[i] or not expect[i]))
    assert qinf[n - 1] and qinf[n:].all()  # r = 0, and the padding
    one_ok, one_dg = S.ecdsa_verify_batch_glv(
        *[torch.from_numpy(np.ascontiguousarray(a[:1024])) for a in arrays])
    assert one_ok.tolist() == ok[:1024].tolist()
    assert one_dg.tolist() == degen[:1024].tolist()
    assert degen[:n].any() and not ok[n:].any() and not degen[n:].any()
    final = np.where(degen[:n], expect, ok[:n])
    assert final.tolist() == expect


def test_dryrun_at_width_8(capsys):
    """The reference's dryrun leg: a valid and a corrupt signature among
    padded lanes, eight shards."""
    sig_shard.dryrun(8)
    assert "8-chip sharded glv sig batch OK" in capsys.readouterr().out
