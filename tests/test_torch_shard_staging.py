"""The sharded paths' kept staging and shard runner (parallel/sig_shard.py
``_Staging``, ``_verify_shards``, ``_msm_shards``; parallel/mesh.py
``run_shards``; K13) on the CPU, where the plain versions stand in for the
kernels.

- The buffers a (program, lanes a shard, layout) keeps are refilled by
  every call: a smaller batch after a larger one at the same lanes, and
  another width after the first, give their own planes, verdicts and
  partials; a shard that held records and now holds padding alone reports
  nothing (its lanes poisoned, its MSM partial at infinity, skipped by the
  fold).
- The folds are the reference's: the verdict and degen planes in row
  order, ``fails`` the psum of ``(~ok | degen) & (q_inf == 0)``, the MSM's
  Jacobian partials added by the oracle.
- A batch of four waves (the records tiled four times, one wave a shard)
  gives the untiled batch's verdicts four times; the tiled MSM terms sum
  to 4 S, zero exactly where S is.
- ``run_shards`` queues every shard's copies in before any launch, and
  every launch and copy out before any wait; on an error it drains every
  stream; the nonce sweep runs on it at one width after another.

Where a test holds the staging and folds alone, a model of the per-shard
kernel stands in for the plain version (the plain verify costs about a
second a shard): the verdict model reads the staged bytes, the MSM model
sums the staged terms through their known discrete logs. The verdicts and
sums of the rest come from the plain versions and are held against the
oracle (crypto/secp256k1.py). No JAX program is compiled. Every comparison
is exact.
"""

import random

import numpy as np
import pytest
import torch

from bitcoincashplus_tpu_torch.crypto import secp256k1 as oracle
from bitcoincashplus_tpu_torch.ops import cuda_build
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as E
from bitcoincashplus_tpu_torch.ops import miner
from bitcoincashplus_tpu_torch.ops import secp256k1 as S
from bitcoincashplus_tpu_torch.ops.sha256_sweep import header_template
from bitcoincashplus_tpu_torch.parallel import mesh, nonce_shard, sig_shard
from bitcoincashplus_tpu_torch.script.interpreter import SigCheckRecord

P, N, G = oracle.P, oracle.N, oracle.G
CPU = torch.device("cpu")


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


def records(n: int, seed: int) -> list:
    """n signatures: valid ones, every third forged, and an out-of-range r
    (a q_inf lane) at lane 4."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        d, e = rng.randrange(1, N), rng.randrange(N)
        r, s = oracle.ecdsa_sign(d, e)
        out.append(SigCheckRecord(oracle.point_mul(d, G), 0 if i == 4 else r,
                                  s, (e + (i % 3 == 2)) % N))
    return out


@pytest.fixture(scope="module")
def corpus():
    """13 records and the oracle's verdicts (made once: the oracle's
    point multiplications cost about a tenth of a second each)."""
    recs = records(13, 5)
    return recs, [oracle.ecdsa_verify(r.pubkey, r.r, r.s, r.msg_hash)
                  for r in recs]


# ---- the staging and the verify fold, on a model of the kernel ---------------

PACKS = {"glv_dev": E.pack_records_w4_bytes, "glv": E.pack_records_glv,
         "w4": E.pack_records_w4_bytes}


def lane_model(arrays, qinf):
    """The verdict model: ok where the first input's last byte of a lane
    is odd, degen where its last but one is; q_inf lanes report nothing,
    as the kernels' do."""
    live = np.asarray(qinf) == 0
    first = np.asarray(arrays[0])
    return (first[:, -1] & 1).astype(bool) & live, \
        (first[:, -2] & 1).astype(bool) & live


@pytest.mark.parametrize("name", sorted(PACKS))
def test_planes_in_row_order_and_fails_through_kept_staging(monkeypatch,
                                                            corpus, name):
    """13 records at width 4, 4 lanes a shard; then 5 at the same staging
    object (shards 2 and 3 now padding alone); then width 2, 8 lanes a
    shard: each call's planes are the model's on a pack of its whole
    batch, in row order (each shard packed on its own equals its rows of
    the whole pack), its padding lanes report nothing, and fails is the
    psum over real lanes."""
    wrapper, _entry, _row, qinf_at = sig_shard._PROGRAMS[name]

    def model(*ts):
        ok, degen = lane_model([t.numpy() for t in ts], ts[qinf_at].numpy())
        return torch.from_numpy(ok), torch.from_numpy(degen)

    monkeypatch.setattr(S, wrapper, model)
    pack, big = PACKS[name], corpus[0]
    kept = None
    for recs, width, per in ((big, 4, 4), (big[:5], 4, 4), (big, 2, 8)):
        devices = [CPU] * width
        ok, degen, fails = sig_shard._verify_shards(
            name, sig_shard._pack_rows(pack, recs, per), "pack", per,
            devices)
        whole = pack(recs, per * width)
        want_ok, want_dg = lane_model(whole, whole[qinf_at])
        assert ok.tolist() == want_ok.tolist()
        assert degen.tolist() == want_dg.tolist()
        assert not ok[len(recs):].any() and not degen[len(recs):].any()
        assert fails == int(np.sum((~ok | degen) & (whole[qinf_at] == 0)))
        st = sig_shard._STAGING[(name, per, tuple(devices))]
        if width == 4:
            assert kept is None or st is kept
            kept = st


def test_packs_into_kept_buffers_equal_new_packs(corpus):
    """A pack into buffers that held another batch writes every lane: the
    same bytes as a pack into new arrays, padding poisoned."""
    big, small = corpus[0][:9], corpus[0][9:12]
    terms = [(oracle.point_mul(k, G)[0], oracle.point_mul(k, G)[1], k)
             for k in (3, 5, 7)]
    for pack, items in ((E.pack_records_w4_bytes, (big, small)),
                        (E.pack_records_glv, (big, small)),
                        (E._msm_pack, (terms, terms[:1]))):
        kept = [a.copy() for a in pack(items[0], 16)]
        pack(items[1], 16, into=kept)
        for a, b in zip(kept, pack(items[1], 16)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---- the verdicts, on the plain versions -------------------------------------

def test_smaller_batch_after_a_larger_one_gives_its_own_verdicts(corpus):
    """verify_batch_sharded under the GLV device split at width 2: 13
    records, then 5 of them (the same staging: shard 1 now padding alone),
    then 7 at width 1 (another staging): each call's verdicts are the
    oracle's."""
    big, want = corpus
    for recs, width in ((big, 2), (big[:5], 2), (big[:7], 1)):
        got = sig_shard.verify_batch_sharded(recs, width, kernel="glv")
        assert got.tolist() == want[:len(recs)]


def test_four_waves_give_the_untiled_verdicts_four_times(corpus):
    """The records tiled four times at width 4 (one copy a shard) under the
    GLV device split: the untiled batch's verdicts at width 1, four times,
    and the oracle's."""
    recs, want = corpus[0][:6], corpus[1][:6]
    one = sig_shard.verify_batch_sharded(recs, 1, kernel="glv")
    four = sig_shard.verify_batch_sharded(recs * 4, 4, kernel="glv")
    assert one.tolist() == want
    assert four.tolist() == one.tolist() * 4


# ---- the MSM staging and fold ------------------------------------------------

def logged_terms(m: int, seed: int, zero_sum: bool = False) -> tuple:
    """m terms k_j (c + j) G of known logs; zero_sum picks the last scalar
    so that the sum is infinity. Returns (terms, logs)."""
    rng = random.Random(seed)
    c = rng.randrange(1, N - m)
    pt, terms, logs = oracle.point_mul(c, G), [], []
    for j in range(m):
        terms.append((pt[0], pt[1], rng.randrange(1, N)))
        logs.append(c + j)
        pt = oracle.point_add(pt, G)
    if zero_sum:
        rest = sum(k * lg for (_, _, k), lg in zip(terms[:-1], logs))
        terms[-1] = terms[-1][:2] + (-rest * pow(logs[-1], -1, N) % N,)
    return terms, logs


def host_sum(terms, logs):
    s = sum(k * lg for (_, _, k), lg in zip(terms, logs)) % N
    return None if s == 0 else oracle.point_mul(s, G)


def test_msm_staging_reused_and_padding_shards_skipped(monkeypatch):
    """Width 4 on 256 terms (four full 64-term shards), then 100 terms at
    the same staging (shards 2 and 3 padding alone), then width 2: each
    shard's partial is the sum of the terms staged for it (a model of the
    kernel that sums through the known logs, as a Jacobian triple with Z
    = 2), the padding shards at infinity, and the fold's verdict the
    host's."""
    terms, logs = logged_terms(256, 41)
    log_of = {x: lg for (x, _, _), lg in zip(terms, logs)}

    def model(xm, ym, inf8, km):
        s = sum(int.from_bytes(k.numpy().tobytes(), "big")
                * log_of[int.from_bytes(x.numpy().tobytes(), "big")]
                for x, k, f in zip(xm, km, inf8) if not f) % N
        if s == 0:
            return (1, 1, 0), True
        x, y = oracle.point_mul(s, G)
        return (x * 4 % P, y * 8 % P, 2), False

    monkeypatch.setattr(S, "msm_partial_point", model)
    for m, width in ((256, 4), (100, 4), (100, 2)):
        devices = [CPU] * width
        per = E._msm_bucket_for(-(-m // width))
        parts = sig_shard._msm_shards(
            sig_shard._pack_rows(E._msm_pack, terms[:m], per), "pack", per,
            devices)
        for c, ((x, y, z), inf) in enumerate(parts):
            want = host_sum(terms[c * per:min(m, (c + 1) * per)],
                            logs[c * per:min(m, (c + 1) * per)])
            assert inf is (want is None)
            if want is not None:
                zi = pow(z, -1, P)
                assert (x * zi * zi % P, y * zi ** 3 % P) == want
        if m == 100 and width == 4:
            assert [inf for _, inf in parts] == [False, False, True, True]
        assert sig_shard.msm_is_infinity_sharded(terms[:m], width) is \
            (host_sum(terms[:m], logs[:m]) is None)


@pytest.mark.parametrize("zero_sum", [False, True], ids=["nonzero", "zero"])
def test_four_waves_of_msm_terms_sum_to_four_times_the_sum(zero_sum):
    """12 terms tiled four times at width 4, on the plain MSM: zero exactly
    where the untiled sum is, as the untiled batch at width 1."""
    terms, logs = logged_terms(12, 51, zero_sum)
    assert (host_sum(terms, logs) is None) is zero_sum
    assert sig_shard.msm_is_infinity_sharded(terms, 1) is zero_sum
    assert sig_shard.msm_is_infinity_sharded(terms * 4, 4) is zero_sum


# ---- the prepared launches ---------------------------------------------------

@pytest.mark.parametrize("name,lanes,launches", [
    ("glv_dev_verify", S.GLV_SPLIT + 1024, [S.GLV_SPLIT, 1024]),
    ("w4_verify_bytes", 2048, [2048])])
def test_a_prepared_launch_fixes_pointers_shape_and_counts(monkeypatch, name,
                                                           lanes, launches):
    """verify_plan on kept buffers: the entry of the launch table's team
    code, one launch a GLV_SPLIT lanes with each input's, the comb's and
    the two output rows' pointers at the launch's first lane, and one
    count a launch, on the stream the caller names. (The C entries are
    stood in for: there is no card here.)"""
    calls = []

    def entry(ename, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append((ename, args))
            return 0
        return fn

    comb = torch.zeros(8, dtype=torch.int32)
    monkeypatch.setattr(cuda_build, "entry", entry)
    monkeypatch.setattr(S, "_comb_on", lambda dev, form: comb)
    S.reset_launch_counts()
    row = E.W4_BYTES_ROW
    inputs = [torch.zeros((lanes, w) if w > 1 else lanes, dtype=torch.uint8)
              for w in row]
    out = torch.zeros(2, lanes, dtype=torch.uint8)
    launch = S.verify_plan(name, inputs, out)
    assert calls == [] and S.LAUNCHES[name] == 0
    launch(77)
    assert [c[1][-4] for c in calls] == launches
    start = 0
    for (ename, args), n in zip(calls, launches):
        team, block = S.launch_shape(n, S.GLV_LAUNCH if "glv" in name
                                     else S.ECDSA_LAUNCH)
        glv = "glv" in name
        assert ename == (name + "_pair" if glv and team > S.GLV_PAIR
                         else name)
        ptrs = [x[start:].data_ptr() for x in inputs] + (
            [comb.data_ptr()] if glv else []) + [
            out[0, start:].data_ptr(), out[1, start:].data_ptr()]
        assert list(args[:len(ptrs)]) == ptrs
        assert args[-3:] == (team - S.GLV_PAIR if team > S.GLV_PAIR
                             else team, block, 77)
        start += n
    assert S.LAUNCHES[name] == len(launches)
    assert S.LAUNCH_SHAPES == {(name, n): launches.count(n)
                               for n in launches}


# ---- the shard runner --------------------------------------------------------

class FakeEvent:
    def __init__(self, log, slot):
        self.log, self.slot = log, slot

    def record(self, stream):
        self.log.append(("record", self.slot))

    def synchronize(self):
        self.log.append(("wait", self.slot))


class FakeStream:
    def __init__(self, log, slot):
        self.log, self.slot = log, slot

    def synchronize(self):
        self.log.append(("drain", self.slot))


def fake_cuda(monkeypatch, log):
    """CUDA layouts without a card: each shard's stream and event log
    what is done with them, and making a stream current logs it."""
    monkeypatch.setattr(mesh, "shard_streams", lambda devices: [
        (FakeStream(log, c), FakeEvent(log, c))
        for c in range(len(devices))])
    monkeypatch.setattr(mesh, "_current_streams", lambda devices: ["back"])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(mesh, "_set_streams", lambda streams: log.extend(
        ("current", getattr(s, "slot", s)) for s in streams))


@pytest.mark.parametrize("width", [1, 3])
def test_every_shard_is_queued_before_any_wait(monkeypatch, width):
    """On CUDA devices every shard's copies in are queued before any
    launch, each shard's launch, copies out and event in turn, and only
    then the waits: nothing waits between two shards' submissions. Each
    shard's work queues with its stream current (at width 1: the current
    stream, nothing switched), and the cards' streams are put back."""
    log = []
    fake_cuda(monkeypatch, log)
    devices = [torch.device("cuda", c) for c in range(width)]
    outs = mesh.run_shards(
        devices, lambda dev, c: log.append(("launch", c)) or c,
        [(c,) for c in range(width)],
        stage=lambda dev, c: log.append(("stage", c)) or (c,),
        collect=lambda dev, c: log.append(("collect", c)) or 10 * c)
    assert outs == [10 * c for c in range(width)]
    switch = width > 1  # at width 1 the current stream, and no switch
    assert log == ([e for c in range(width) for e in (
        [("current", c)] if switch else []) + [("stage", c)]]
        + [e for c in range(width) for e in (
            [("current", c)] if switch else []) + [
            ("launch", c), ("collect", c), ("record", c)]]
        + [("wait", c) for c in range(width)]
        + ([("current", "back")] if switch else []))


def test_a_failed_launch_drains_every_stream(monkeypatch):
    """A launch that raises: every shard's stream is drained (no copy left
    reading a host buffer the next call refills), the cards' streams are
    put back, and the error propagates."""
    log = []
    fake_cuda(monkeypatch, log)

    def launch(dev, c):
        if c == 1:
            raise cuda_build.KernelUnavailable("launch failed")
        return c

    with pytest.raises(cuda_build.KernelUnavailable):
        mesh.run_shards([torch.device("cuda", c) for c in range(3)], launch,
                        [(c,) for c in range(3)])
    assert log[-4:] == [("drain", 0), ("drain", 1), ("drain", 2),
                        ("current", "back")]
    assert not any(e[0] == "wait" for e in log)


def test_the_sweep_runs_on_the_runner_at_one_width_after_another():
    """sweep_header_sharded at widths 4, 2 and 4 on one header: each
    shard's tiles and hit are the unsharded exact sweep's on its stripe,
    and the fold's nonce the least hit."""
    hdr = random.Random(3).randbytes(76) + bytes(4)
    target, tile, budget = 1 << 246, 256, 1 << 12
    tmpl = header_template(hdr, CPU)
    tgt = miner.target_tensor(target, CPU)
    for width in (4, 2, 4):
        nonce, hashes, per_chip = nonce_shard.sweep_header_sharded(
            hdr, target, 0, budget, tile=tile, n_chips=width,
            return_per_chip=True)
        n_tiles = budget // width // tile
        ref = [miner.sweep(tmpl, tgt, c * n_tiles * tile, n_tiles,
                           tile).tolist() for c in range(width)]
        hits = [nc for found, nc, _ in ref if found]
        assert per_chip == [t for _, _, t in ref]
        assert nonce == (min(hits) if hits else None)
        assert hashes == sum(per_chip) * tile
