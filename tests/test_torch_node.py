"""The port's node (node/node.py of bitcoincashplus_tpu_torch) runs the
reference's -reindex in process over a small signature chain
(workload/sigchain.generate: 600 dense P2PKH signatures, so the native
connect engine hands dispatch_packed one slice of 601, above its 512-lane
device floor).

Without the device (-tpu=0) the port's node and the JAX package's node
reach the same best block, height and coin-set muhash. On the device path
with the port's device switch on the CPU (the kernels' plain versions),
the port's node reaches the same under the default GLV kernel and under
BCP_SECP_PALLAS=0 -ecdsakernel=w4, where the packed slice takes the record
route to the bit ladder (K8) at the reference's plane bucket 2048. The
reference's node runs with -tpu=0 only: it compiles no JAX program.
"""

import os
import shutil

import pytest
import torch

from bitcoincashplus_tpu.node.config import Config as RefConfig
from bitcoincashplus_tpu.node.node import Node as RefNode
from bitcoincashplus_tpu_torch.ops import cuda_build
from bitcoincashplus_tpu_torch.ops import ecdsa_batch as teb
from bitcoincashplus_tpu_torch.workload import sigchain

CHAIN_SIGS = 600


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("sigchain"))
    gen = sigchain.generate(base, CHAIN_SIGS, tip_inputs=1)
    assert gen["sigs"] == CHAIN_SIGS
    return base


def _copy(base, tmp_path, tag):
    d = os.path.join(str(tmp_path), tag)
    shutil.copytree(base, d)
    return d


def _ref_reindex(datadir, **flags):
    cfg = RefConfig()
    cfg.args.update(datadir=[datadir], regtest=["1"], reindex=["1"])
    for name, value in flags.items():
        cfg.args[name] = [str(value)]
    node = RefNode(config=cfg)
    try:
        tip = node.chainstate.tip()
        return {"height": tip.height, "best": tip.hash.hex(),
                "muhash": node.coins_db.muhash_digest().hex(),
                "engine": "native" if node.last_import_stats else "python"}
    finally:
        node.close()


@pytest.fixture(scope="module")
def cpu_run(chain, tmp_path_factory):
    """The port's node with -tpu=0: the digest of record."""
    tmp = tmp_path_factory.mktemp("cpu_run")
    return sigchain.reindex(_copy(chain, tmp, "port"), tpu=0)


def test_port_and_reference_nodes_agree_without_the_device(chain, cpu_run,
                                                           tmp_path):
    ref = _ref_reindex(_copy(chain, tmp_path, "ref"), tpu=0)
    assert {k: cpu_run[k] for k in ref} == ref
    # the chain: 100 runway blocks past the genesis, the fan-out, a dense
    # block
    assert cpu_run["height"] == 103


PROGRAMS = ("_PW_GLV_DEV", "_PW_GLV", "_PW_W4_BYTES", "_PW_W4", "_PW_XLA")


@pytest.mark.parametrize("route", ["glv", "ladder"])
def test_port_node_device_path(chain, cpu_run, tmp_path, monkeypatch, route):
    """-reindex on the device path (the plain versions on the CPU): GLV
    under the default kernel; the bit ladder at bucket 2048 under
    BCP_SECP_PALLAS=0 -ecdsakernel=w4, with no GLV or w4 dispatch. No
    signature falls back to the CPU engine."""
    before = cuda_build.device()
    cuda_build.set_device("cpu")
    # "auto" on the CPU device prefers the native CPU batch (as the
    # reference on a CPU backend): the device path is forced here
    monkeypatch.setattr(teb, "_device_available", lambda: True)
    monkeypatch.setattr(teb, "_KERNEL", None)  # -ecdsakernel sets it
    flags = {}
    if route == "ladder":
        monkeypatch.setenv("BCP_SECP_PALLAS", "0")
        flags["ecdsakernel"] = "w4"
    counts0 = {p: getattr(teb, p).dispatches for p in PROGRAMS}
    xla0 = teb._PW_XLA.signatures.get((2048,), 0)
    fallback0 = (teb.STATS.cpu_fallback_sigs, teb.STATS.fault_fallback_sigs)
    try:
        run = sigchain.reindex(_copy(chain, tmp_path, route), **flags)
    finally:
        cuda_build.set_device(before)
    assert {k: run[k] for k in ("height", "best", "muhash")} == \
        {k: cpu_run[k] for k in ("height", "best", "muhash")}
    assert run["engine"] == cpu_run["engine"]
    ran = {p: getattr(teb, p).dispatches - counts0[p] for p in PROGRAMS}
    if route == "glv":
        assert ran["_PW_GLV_DEV"] >= 1
        assert ran["_PW_XLA"] == ran["_PW_W4_BYTES"] == ran["_PW_W4"] == 0
    else:
        assert ran["_PW_XLA"] >= 1
        assert teb._PW_XLA.signatures[(2048,)] > xla0
        assert ran["_PW_GLV_DEV"] == ran["_PW_GLV"] == 0
        assert ran["_PW_W4_BYTES"] == ran["_PW_W4"] == 0
    assert (teb.STATS.cpu_fallback_sigs,
            teb.STATS.fault_fallback_sigs) == fallback0
