"""The port's daemon (bitcoincashplus_tpu_torch/cli/bcpd.py) as users run
it: a real process, driven over JSON-RPC through the functional test
framework's TestNode, with ``-device=cpu`` (the kernels' plain versions;
without it the daemon is on the card or raises).

A 600-signature signature chain (workload/sigchain.generate) is
``-reindex``ed by the daemon with ``-tpu=0`` and by the reference's node
in process (``-tpu=0``: it compiles no JAX program); the two reach the
same best block, height and coin-set muhash. The port's daemon then opens,
without ``-reindex``, a datadir the reference's node wrote, and reports the
same tip and muhash (state carried across). Over RPC: ``gettpuinfo`` with
the reference's keys and ``devices == ["cpu"]``; ``startprofile`` /
``stopprofile`` writing a trace; ``submitblock`` rejecting the chain's
tampered tip (the tip stays; sent again it is "duplicate-invalid") and
taking its good one; ``generatetoaddress 2``; ``bcp_cli
getblockcount``; and ``stop`` ending the process with exit 0.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from bitcoincashplus_tpu.node.config import Config as RefConfig
from bitcoincashplus_tpu.node.node import Node as RefNode
from bitcoincashplus_tpu_torch.workload import sigchain
from functional import framework

CHAIN_SIGS = 600


class PortNode(framework.TestNode):
    """A TestNode running the port's bcpd on the CPU switch."""

    def args(self, extra=()):
        args = super().args(extra)
        assert args[2] == "bitcoincashplus_tpu.cli.bcpd"
        args[2] = "bitcoincashplus_tpu_torch.cli.bcpd"
        return [*args, "-device=cpu"]

    def stop_and_wait(self) -> int:
        proc = self.process
        assert self.rpc.stop() == "bcpd stopping"
        rc = proc.wait(60)
        self.process = None
        return rc


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("sigchain"))
    gen = sigchain.generate(base, CHAIN_SIGS, tip_inputs=1)
    assert gen["sigs"] == CHAIN_SIGS
    return base, gen


def _ref_node(datadir, **flags):
    cfg = RefConfig()
    cfg.args.update(datadir=[datadir], regtest=["1"])
    for name, value in flags.items():
        cfg.args[name] = [str(value)]
    return RefNode(config=cfg)


@pytest.fixture(scope="module")
def reference(chain, tmp_path_factory):
    """The reference's node -reindexes a copy in process; its datadir is
    kept for the port's daemon to open."""
    d = str(tmp_path_factory.mktemp("ref") / "chain")
    shutil.copytree(chain[0], d)
    node = _ref_node(d, reindex=1, tpu=0)
    try:
        tip = node.chainstate.tip()
        out = {"datadir": d, "height": tip.height,
               "best": tip.hash[::-1].hex(),
               "muhash": node.coins_db.muhash_digest().hex()}
    finally:
        node.close()
    return out


def _node_on(datadir_src, tmp_path) -> PortNode:
    node = PortNode(0, str(tmp_path))
    shutil.rmtree(node.datadir_base)
    shutil.copytree(datadir_src, node.datadir_base)
    return node


def _tip(node) -> dict:
    info = node.rpc.getblockchaininfo()
    utxo = node.rpc.gettxoutsetinfo()
    assert info["bestblockhash"] == utxo["bestblock"]
    return {"height": info["blocks"], "best": info["bestblockhash"],
            "muhash": utxo["muhash"]}


def _gettpuinfo_keys() -> set:
    """The keys of the reference's gettpuinfo result literal."""
    path = os.path.join(framework.REPO_ROOT, "bitcoincashplus_tpu", "rpc", "control.py")
    fn = next(n for n in ast.parse(open(path).read(), path).body
              if isinstance(n, ast.FunctionDef) and n.name == "gettpuinfo")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


def test_daemon_reindex_and_rpc(chain, reference, tmp_path):
    """-reindex -tpu=0 reaches the reference's tip and muhash; then
    gettpuinfo, the profiler, submitblock, generatetoaddress, bcp_cli and
    stop, all over RPC."""
    base, gen = chain
    node = _node_on(base, tmp_path)
    node.start(["-reindex", "-tpu=0"])
    try:
        assert _tip(node) == {k: reference[k]
                              for k in ("height", "best", "muhash")}

        info = node.rpc.gettpuinfo()
        assert set(info) == _gettpuinfo_keys()
        assert info["devices"] == ["cpu"] and info["backend"] == "cpu"
        assert info["ecdsa"]["kernel"] == "glv"
        assert set(info["device"]) == {
            "programs", "transfer_bytes", "unattributed_compiles",
            "compilation_cache", "profiler", "watchdog"}

        prof_dir = os.path.join(str(tmp_path), "profile")
        assert node.rpc.startprofile(prof_dir) == {"path": prof_dir,
                                                   "active": True}
        with pytest.raises(Exception, match="already active"):
            node.rpc.startprofile(prof_dir)
        height = reference["height"]
        # the reference's submitblock: the tampered signature fails at the
        # block's settle, which marks it invalid and leaves the tip (the
        # call itself returns None); sent again, it is "duplicate-invalid"
        node.rpc.submitblock(gen["tampered_tip"].hex())
        assert node.rpc.getblockcount() == height
        assert node.rpc.submitblock(gen["tampered_tip"].hex()) == \
            "duplicate-invalid"
        assert node.rpc.submitblock(gen["good_tip"].hex()) is None
        assert node.rpc.getblockcount() == height + 1
        stopped = node.rpc.stopprofile()
        assert stopped["path"] == prof_dir and stopped["seconds"] >= 0
        trace = json.load(open(os.path.join(prof_dir, "trace.json")))
        assert "traceEvents" in trace
        assert node.rpc.gettpuinfo()["device"]["profiler"]["dumps"] == 1

        addr = node.rpc.getnewaddress()
        assert len(node.rpc.generatetoaddress(2, addr)) == 2
        assert node.rpc.getblockcount() == height + 3
        assert node.rpc.gettpuinfo()["mining"]["engine"] == "scalar-host"

        cli = subprocess.run(
            [sys.executable, "-m", "bitcoincashplus_tpu_torch.cli.bcp_cli",
             "-regtest", f"-datadir={node.datadir_base}",
             f"-rpcport={node.rpc_port}", "getblockcount"],
            cwd=framework.REPO_ROOT, capture_output=True, text=True, timeout=120)
        assert cli.returncode == 0 and cli.stdout.strip() == str(height + 3)

        assert node.stop_and_wait() == 0
    finally:
        node.stop()


def test_daemon_opens_the_reference_nodes_datadir(reference, tmp_path):
    """State carried across: without -reindex, the port's daemon opens a
    datadir the reference's node wrote and reports its tip and muhash."""
    node = _node_on(reference["datadir"], tmp_path)
    node.start()
    try:
        assert _tip(node) == {k: reference[k]
                              for k in ("height", "best", "muhash")}
        assert node.stop_and_wait() == 0
    finally:
        node.stop()


def test_daemon_without_the_cpu_switch_needs_a_card(tmp_path):
    """No -device=cpu and no card: the daemon raises at start, and
    -device= takes only cuda or cpu."""
    env = dict(os.environ, PYTHONPATH=framework.REPO_ROOT, CUDA_VISIBLE_DEVICES="")
    for flag, what in (([], "needs CUDA"), (["-device=tpu"], "-device")):
        proc = subprocess.run(
            [sys.executable, "-m", "bitcoincashplus_tpu_torch.cli.bcpd",
             "-regtest", f"-datadir={tmp_path}", *flag],
            cwd=framework.REPO_ROOT, env=env, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode != 0 and what in proc.stderr
        assert "bcpd started" not in proc.stdout


def test_profiler_starts_and_stops_on_any_thread(tmp_path, monkeypatch):
    """util/devicewatch's profiler window, as the RPCs drive it: started on
    one thread and stopped on another (torch's profiler itself must stop
    on the thread that started it), a second start and a stop without a
    start refused with the reference's RuntimeErrors, the trace written,
    the state in snapshot() under the reference's keys; reset() drops
    the program watches."""
    import threading

    from bitcoincashplus_tpu_torch.ops import cuda_build
    from bitcoincashplus_tpu_torch.util import devicewatch as dw

    monkeypatch.setattr(cuda_build, "_DEVICE", None)
    cuda_build.set_device("cpu")
    out = {}

    def call(name, *args):
        def run():
            try:
                out[name] = getattr(dw, name)(*args)
            except RuntimeError as e:
                out[name] = e
        t = threading.Thread(target=run)
        t.start()
        t.join()
        return out[name]

    with pytest.raises(RuntimeError, match="not active"):
        dw.stop_profile()
    dumps = dw.profile_snapshot()["dumps"]
    path = str(tmp_path / "prof")
    assert call("start_profile", path) == {"path": path, "active": True}
    assert isinstance(call("start_profile", path), RuntimeError)
    assert dw.snapshot()["profiler"] == {"active": True, "path": path,
                                         "dumps": dumps}
    stopped = call("stop_profile")
    assert stopped["path"] == path and stopped["seconds"] >= 0
    assert "traceEvents" in json.load(open(os.path.join(path, "trace.json")))
    assert dw.profile_snapshot() == {"active": False, "path": None,
                                     "dumps": dumps + 1}
    # reset() drops the registry; the watches the modules hold are put
    # back after, for the tests that run next in this process
    monkeypatch.setattr(dw, "_PROGRAMS", dict(dw._PROGRAMS))
    monkeypatch.setattr(dw, "_TRANSFERS", dict(dw._TRANSFERS))
    for name in ("_entries", "_beat_totals"):
        monkeypatch.setattr(dw.WATCHDOG, name,
                            dict(getattr(dw.WATCHDOG, name)))
    dw.program("test_torch_daemon_probe")
    assert "test_torch_daemon_probe" in dw.snapshot()["programs"]
    dw.reset()
    assert dw.snapshot()["programs"] == {}
    assert dw.snapshot()["transfer_bytes"] == {}
