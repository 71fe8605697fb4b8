"""The port package stands alone: importing its block-validation and
mining modules, the daemon (cli/bcpd and the RPC, P2P and wallet modules
it starts) and the sharded paths loads neither jax nor any module of the
JAX package; no
port file imports them; and every host module the port copied from the
JAX package is byte-identical to its original, apart from the differences
listed here."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "bitcoincashplus_tpu_torch")
REF = os.path.join(REPO, "bitcoincashplus_tpu")

# host modules copied from the JAX package (relative imports bind them to
# the port's own ops/ and util/)
HOST_COPIES = (
    "__init__ util/__init__ util/log util/telemetry util/faults "
    "util/lockwatch crypto/__init__ crypto/hashes crypto/secp256k1 "
    "crypto/base58 consensus/__init__ consensus/serialize consensus/tx "
    "consensus/tx_check consensus/block consensus/merkle consensus/params "
    "consensus/versionbits consensus/pow script/__init__ script/script "
    "script/sighash script/interpreter store/kvstore store/blockstore "
    "store/chainstatedb store/muhash store/certificate validation/__init__ "
    "validation/chain validation/coins validation/sigcache "
    "validation/scriptcheck validation/chainstate wallet/keys wallet/signing "
    "native mining/__init__ mining/assembler mining/generate "
    "mempool/__init__ mempool/accept mempool/fees mempool/mempool "
    "mempool/persist mempool/policy store/sharded store/snapshot "
    "serving/__init__ serving/gateway serving/replicas serving/sigservice "
    "node/__init__ node/config node/node "
    "wallet/__init__ wallet/bip32 wallet/crypter wallet/message "
    "wallet/wallet crypto/aes crypto/siphash consensus/merkleblock "
    "rpc/__init__ rpc/registry rpc/server rpc/client rpc/blockchain "
    "rpc/mining rpc/net rpc/rawtransaction rpc/rest rpc/wallet rpc/zmq "
    "rpc/control p2p/__init__ p2p/protocol p2p/addrman p2p/bloom "
    "p2p/compact p2p/connman cli/__init__ cli/bcp_cli cli/bcp_tx cli/bcpd "
    "parallel/__init__"
).split()
# the package __init__ is the port's own (its docstring describes the port)
HOST_COPIES.remove("__init__")


def _reraise_kernel_unavailable(src: str) -> str:
    # a kernel that cannot be built or launched must surface, not degrade
    # to the CPU engine like a transient device failure: at the serial
    # dispatch and at settle (where a LanePacker's tail flush dispatches)
    for indent, comment in ((" " * 20, "programming errors surface, "
                             "not degrade"),
                            (" " * 16, "programming errors must surface, "
                             "not degrade")):
        old = (f"{indent}except (KeyboardInterrupt, SystemExit,\n"
               f"{indent}        NameError, AttributeError, "
               "UnboundLocalError):\n"
               f"{indent}    raise  # {comment}\n")
        new = (f"{indent}except (KeyboardInterrupt, SystemExit,\n"
               f"{indent}        NameError, AttributeError, "
               "UnboundLocalError,\n"
               f"{indent}        ecdsa_batch.KernelUnavailable):\n"
               f"{indent}    raise  # programming errors, missing kernel "
               "surface\n")
        assert src.count(old) == 1
        src = src.replace(old, new)
    return src


def _no_jax_platform_pin(src: str) -> str:
    # the node's start pinned jax to its CPU platform when the backend
    # probe said CPU; the port imports no jax, and its device switch
    # (ops/cuda_build.set_device) is the whole of that choice
    old = src[src.index("        # JAX_PLATFORMS=cpu must actually mean CPU"):
              src.index("        os.makedirs(self.datadir, exist_ok=True)")]
    assert src.count(old) == 1 and "import jax" in old
    return src.replace(old, "")


def _torch_device_list(src: str) -> str:
    # gettpuinfo's device list: jax.devices() inside a try that swallowed
    # every exception becomes the port's device switch's names (each
    # card's name under CUDA, ["cpu"] under the CPU switch), raising where
    # it fails (works on the file and on the unparsed function alike)
    start = src.index("    devices = []\n")
    end = src.index("        pass\n", start) + len("        pass\n")
    old = src[start:end]
    assert src.count(old) == 1 and "import jax" in old
    return src.replace(old, "    devices = ecdsa_batch.device_names()\n")


def _torch_rpc_control(src: str) -> str:
    # the device list above, and the profiler RPCs' docstrings: their code
    # is the reference's (util/devicewatch's start_profile/stop_profile
    # run torch.profiler), their dump a Chrome trace
    src = _torch_device_list(src)
    for old, new in (
        ("    Start an on-demand jax.profiler trace (device-side XLA timeline —\n"
         "    the layer below the span tracer's host view). Default directory:\n"
         "    <datadir>/profile. Stop with ``stopprofile``; the dump is\n"
         "    TensorBoard-compatible (plugins/profile/<ts>/*.xplane.pb +\n"
         "    trace.json.gz — load with tensorboard --logdir or xprof). Errors if\n"
         "    a profile is already running (the profiler is process-global).",
         "    Start an on-demand torch.profiler trace (host and CUDA activity, the\n"
         "    card's kernels by name — the layer below the span tracer's host\n"
         "    view). Default directory: <datadir>/profile. Stop with\n"
         "    ``stopprofile``; the dump is a Chrome trace, <dir>/trace.json (load\n"
         "    at ui.perfetto.dev or chrome://tracing). Errors if a profile is\n"
         "    already running (the profiler is process-global)."),
        ("    Stop the running jax.profiler trace started by",
         "    Stop the running torch.profiler trace started by")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def _device_switch(src: str) -> str:
    # bcpd's -device= (cuda by default, cpu for the tests) sets the port's
    # device switch before the node starts; with no card it raises, and
    # its "bcpd started" line names the device
    for old, new in (
        ("from ..node.node import InitError, Node\n",
         "from ..node.node import InitError, Node\n"
         "from ..ops import cuda_build\n"),
        ("    try:\n        node = Node(config)\n",
         "    # the device the kernels run on: the card unless -device=cpu (the\n"
         "    # kernels' plain versions, for tests); with no card the daemon "
         "raises\n"
         "    device = config.get(\"device\", \"cuda\")\n"
         "    try:\n"
         "        cuda_build.set_device(device)\n"
         "    except (ValueError, RuntimeError) as e:  # not cuda or cpu\n"
         "        print(f\"Error parsing command line arguments: -device: {e}\",\n"
         "              file=sys.stderr)\n"
         "        return 1\n"
         "    try:\n"
         "        cuda_build.require_device(\"bcpd\")\n"
         "        node = Node(config)\n"),
        ("datadir={node.datadir}\",\n          flush=True)",
         "datadir={node.datadir}\"\n"
         "          f\" device={cuda_build.device()}\", flush=True)")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def _replacing(*pairs):
    """A listed difference made of exact replacements, each found once."""
    def apply(code: str) -> str:
        for old, new in pairs:
            assert code.count(old) == 1, old
            code = code.replace(old, new)
        return code
    return apply


# a kernel that cannot be built or launched must surface to the service's
# callers, not degrade to the caller-side CPU re-verify like a transient
# flush failure: the settle re-raises it (the thread dies, its other
# in-flight lanes and the lanes queued behind them carry it, later
# submits flush inline and raise), and
# TxSigFuture.result() raises it for a lane that carries it
_SIGSERVICE_RAISES_KERNEL_UNAVAILABLE = _replacing(
    ("dropped or fabricated, and ``-sigservice=off`` is byte-identical by\n"
     "construction (the callers run the unchanged synchronous path).\n",
     "dropped or fabricated, and ``-sigservice=off`` is byte-identical by\n"
     "construction (the callers run the unchanged synchronous path). A "
     "kernel\nthat cannot be built or launched (KernelUnavailable) is not "
     "degraded: it\nraises to every waiter of the flush, and the service "
     "thread dies with it.\n"),
    ("        eventual block connect still gets its cache hit.\"\"\"\n",
     "        eventual block connect still gets its cache hit. A lane whose\n"
     "        flush met a kernel that cannot be built or launched\n"
     "        (KernelUnavailable) raises it here instead: that is never\n"
     "        degraded to the CPU.\"\"\"\n"),
    ("            elif src.err is not None or not src.settled():\n",
     "            elif isinstance(src.err, ecdsa_batch.KernelUnavailable):\n"
     "                raise src.err  # a missing kernel surfaces, not "
     "degrades\n"
     "            elif src.err is not None or not src.settled():\n"),
    ("            # NOW — waiters must fail fast to their CPU re-verify, not\n"
     "            # sit out the full result timeout on a dead thread.\n",
     "            # NOW — waiters must fail fast to their CPU re-verify (or, "
     "for\n            # a KernelUnavailable, raise it), not sit out the "
     "full result\n            # timeout on a dead thread.\n"),
    ("                self._inflight.clear()\n"
     "                self._cond.notify_all()\n",
     "                self._inflight.clear()\n"
     "                if isinstance(e, ecdsa_batch.KernelUnavailable):\n"
     "                    # lanes still queued behind the failed flush carry "
     "it\n"
     "                    # too, and running() is False from here, so a "
     "later\n"
     "                    # submit flushes inline and raises it\n"
     "                    for lane in self._pending:\n"
     "                        lane.err = e\n"
     "                        self._by_key.pop(lane.key, None)\n"
     "                    self._pending.clear()\n"
     "                    _QUEUE_G.set(0)\n"
     "                    self._thread = None\n"
     "                self._cond.notify_all()\n"),
    ("                                UnboundLocalError)):\n"
     "                raise err  # programming errors must surface, not "
     "degrade\n",
     "                                UnboundLocalError,\n"
     "                                ecdsa_batch.KernelUnavailable)):\n"
     "                raise err  # programming errors, missing kernel "
     "surface\n"))


# Not in HOST_COPIES, being the port's own: ops/dispatch.py (its
# supervised_call is pinned function by function below),
# mining/resident.py (a CUDA stream of segments in place of JAX async
# dispatch) and parallel/ (one launch a shard in place of shard_map; its
# entry points pinned function by function below).
DIFFERENCES = {
    "validation/scriptcheck": _reraise_kernel_unavailable,
    "serving/sigservice": _SIGSERVICE_RAISES_KERNEL_UNAVAILABLE,
    "node/node": _no_jax_platform_pin,
    "rpc/control": _torch_rpc_control,
    "cli/bcpd": _device_switch,
}


def _fallback_only_for_injected_faults(code: str) -> str:
    # cpu_fn serves only a fault the harness injected (or output it
    # poisoned); anything else, and an open breaker with no fault armed,
    # raises KernelUnavailable: a broken sweep kernel must not turn into
    # the scalar nonce loop
    for old, new in (
        ("        calls = [0]\n",
         "        calls = [0]\n        poisoned = [False]\n"),
        ("            calls[0] += 1\n",
         "            calls[0] += 1\n            poisoned[0] = False\n"),
        ("                out = poison(out)\n",
         "                out = poison(out)\n"
         "                poisoned[0] = True\n"),
        ("        except (KeyboardInterrupt, SystemExit):\n"
         "            raise\n"
         "        except Exception as e:\n",
         "        except (KeyboardInterrupt, SystemExit, KernelUnavailable):\n"
         "            raise\n"
         "        except Exception as e:\n"
         "            raise_kernel_fault(e, f'the {site} kernel')\n"
         "            injected = isinstance(e, InjectedFault) or "
         "(isinstance(e, PoisonedOutput) and poisoned[0])\n"
         "            if not injected:\n"
         "                raise KernelUnavailable(f'the {site} device leg "
         "failed: {type(e).__name__}: {e}') from e\n"),
        ("    br.note_fallback(items)\n",
         "    elif not INJECTOR.armed_for(site):\n"
         "        raise KernelUnavailable(f'the {site} breaker is open and "
         "no fault is injected there: {br.snapshot()}')\n"
         "    br.note_fallback(items)\n")):
        assert code.count(old) == 1, old
        code = code.replace(old, new)
    return code


def _msm_oracle_only_for_injected_faults(code: str) -> str:
    # the MSM rung hands a batch to the per-lane oracle only for a fault
    # the harness injected (an InjectedFault, or a canary trip in an
    # attempt whose verdicts poison-output flipped); anything else raises
    for old, new in (
        ("            INJECTOR.on_call('ecdsa')\n",
         "            poisoned = INJECTOR.poisoned.get(MSM_SITE, 0)\n"
         "            INJECTOR.on_call('ecdsa')\n"),
        ("        except Exception as e:\n            last = e\n",
         "        except Exception as e:\n"
         "            _raise_unless_msm_injected(e, poisoned)\n"
         "            last = e\n")):
        assert code.count(old) == 1, old
        code = code.replace(old, new)
    return code


def _open_breaker_oracle_only_for_injected_faults(code: str) -> str:
    # an open ecdsa breaker sends a Schnorr batch to the oracle only while
    # a fault is armed at ecdsa or ecdsa_msm; otherwise it raises
    old = "        else:\n            br.note_fallback(n)\n"
    new = ("        else:\n"
           "            if not (INJECTOR.armed_for('ecdsa') or "
           "INJECTOR.armed_for(MSM_SITE)):\n"
           "                raise KernelUnavailable(f'the ecdsa breaker is "
           "open and no fault is injected at ecdsa or {MSM_SITE}: "
           "{br.snapshot()}')\n"
           "            br.note_fallback(n)\n")
    assert code.count(old) == 1
    return code.replace(old, new)


def _no_pallas_latch(code: str) -> str:
    # the reference also latched the w4 rung off after a Mosaic failure;
    # in the port a w4 failure raises KernelUnavailable, so only
    # BCP_SECP_PALLAS turns the rung off
    old = "return not _PALLAS_BROKEN and "
    assert code.count(old) == 1
    return code.replace(old, "return ")


# the sharded entry points: a layout (devices=) in place of the mesh, and
# one launch a shard in place of the shard_map program; the signature and
# MSM entries pack each shard's records (terms) straight into its kept
# staging (parallel/sig_shard._pack_rows, _verify_shards, _msm_shards) in
# place of one packed batch, and read the clock for the breakdown of a
# call (parallel/mesh.note); the rest (the stripe budget, the buckets, the
# packs, the rung choice, the host re-check, the MSM fold) is the
# reference's
_LAYOUT_SWEEP = _replacing(
    ("return_per_chip: bool=False):",
     "return_per_chip: bool=False, devices=None):"),
    ("        n_chips = len(local_devices())\n",
     "        n_chips = len(local_devices()) if devices is None else "
     "len(devices)\n    devices = layout(n_chips, devices)\n"),
    ("    midstate = jnp.asarray(np.array(header_midstate(header80), "
     "dtype=np.uint32))\n    tail = jnp.asarray(bytes_to_words_np("
     "np.frombuffer(header80[64:76], dtype=np.uint8)))\n"
     "    tgt = jnp.asarray(target_to_limbs_np(target))\n",
     "    midstate = np.array(header_midstate(header80), dtype=np.uint32)\n"
     "    tail = bytes_to_words_np(np.frombuffer(header80[64:76], "
     "dtype=np.uint8))\n    tgt = target_to_limbs_np(target)\n"),
    ("_sharded_sweep_jit(midstate, tail, tgt, jnp.uint32(start_nonce), "
     "jnp.uint32(n_tiles), tile=tile, n_chips=n_chips)",
     "_sharded_sweep(midstate, tail, tgt, np.uint32(start_nonce), "
     "np.uint32(n_tiles), tile=tile, devices=devices)"))
_PACKED = ("        arrays = [np.asarray(a) for a in {}(records, bucket)]\n"
           "        dw.note_transfer('sig_shard', 'h2d', sum((int(a.nbytes) "
           "for a in arrays)))\n        with dw.program('sig_shard_{}')")
_STAGED = ("        fill = _pack_rows({}, records, per_chip)\n"
           "        dw.note_transfer('sig_shard', 'h2d', bucket * "
           "sum(ecdsa_batch.{}))\n        with dw.program('sig_shard_{}')")
_LAYOUT_VERIFY = _replacing(
    ("kernel: str | None=None) -> np.ndarray:",
     "kernel: str | None=None, devices=None) -> np.ndarray:"),
    ("    n = len(records)\n",
     "    devices = layout(n_chips, devices)\n    n = len(records)\n"),
    *[(_PACKED.format(pack, name), _STAGED.format(pack, row, name))
      for pack, row, name in (
          ("pack_records_w4_bytes", "W4_BYTES_ROW", "glv_dev"),
          ("pack_records_glv", "GLV_ROW", "glv"),
          ("pack_records_w4_bytes", "W4_BYTES_ROW", "w4"))],
    ("jax.block_until_ready(_sharded_glv_dev_jit(*arrays, n_chips=n_chips))",
     "_verify_shards('glv_dev', fill, 'pack', per_chip, devices)"),
    ("jax.block_until_ready(_sharded_glv_jit(*arrays, n_chips=n_chips))",
     "_verify_shards('glv', fill, 'pack', per_chip, devices)"),
    ("jax.block_until_ready(_sharded_w4_jit(*arrays, n_chips=n_chips, "
     "interpret=_use_interpret(n_chips)))",
     "_verify_shards('w4', fill, 'pack', per_chip, devices)"),
    ("    idxs = np.nonzero(degen)[0]\n",
     "    t0 = time.perf_counter()\n    idxs = np.nonzero(degen)[0]\n"),
    ("        out[idxs] = _verify_cpu([records[i] for i in idxs])\n",
     "        out[idxs] = _verify_cpu([records[i] for i in idxs])\n"
     "    note('recheck', t0)\n"))
# and the MSM partials as the port's ((X, Y, Z), inf) ints
# (ops/secp256k1.msm_partial_point) in place of the packed limb column,
# each made affine with pow(z, -1, p) (the same inverse, without the
# exponentiation)
_LAYOUT_MSM = _replacing(
    ("(terms, n_chips: int) -> bool:",
     "(terms, n_chips: int, devices=None) -> bool:"),
    ("    from ..ops.secp256k1 import N_LIMBS, from_limbs_np\n", ""),
    ("    per_chip = _msm_bucket_for(",
     "    devices = layout(n_chips, devices)\n"
     "    per_chip = _msm_bucket_for("),
    ("    arrays = [np.asarray(a) for a in _msm_pack(terms, bucket)]\n"
     "    dw.note_transfer('sig_shard', 'h2d', sum((int(a.nbytes) for a in "
     "arrays)))\n",
     "    fill = _pack_rows(_msm_pack, terms, per_chip)\n"
     "    dw.note_transfer('sig_shard', 'h2d', bucket * sum(E.MSM_ROW))\n"),
    ("np.asarray(jax.block_until_ready(_sharded_msm_jit(*arrays, "
     "n_chips=n_chips)))", "_msm_shards(fill, 'pack', per_chip, devices)"),
    ("    acc = None\n", "    t0 = time.perf_counter()\n    acc = None\n"),
    ("pow(z, oracle.P - 2, oracle.P)", "pow(z, -1, oracle.P)"),
    ("    return acc is None\n", "    note('fold', t0)\n    return acc is None\n"),
    ("        col = out[:, c]\n        if col[3 * N_LIMBS]:\n",
     "        (x, y, z), inf = out[c]\n        if inf:\n"),
    ("        x = from_limbs_np(col[0:N_LIMBS]) % oracle.P\n"
     "        y = from_limbs_np(col[N_LIMBS:2 * N_LIMBS]) % oracle.P\n"
     "        z = from_limbs_np(col[2 * N_LIMBS:3 * N_LIMBS]) % oracle.P\n",
     ""))
# the packs fill kept buffers in place when given them (``into``: the
# sharded path's staging; _zeros and _ones zero or fill the i-th one) in
# place of new arrays
def _into(*allocs):
    """Pairs turning each new array of a pack into its i-th ``into``
    buffer: (old line start, new line start) pairs."""
    return [(f"{name} = np.{fill}({shape}, np.uint8)\n",
             f"{name} = _{fill}(into, {i}, {shape})\n")
            for name, fill, shape, i in allocs]


_PACK_INTO_W4 = _replacing(
    ("bucket: int):", "bucket: int, into=None):"),
    ("    def mat(blob: bytes) -> np.ndarray:\n"
     "        out = np.zeros((bucket, 32), np.uint8)\n",
     "    def mat(blob: bytes, i: int) -> np.ndarray:\n"
     "        out = _zeros(into, i, (bucket, 32))\n"),
    *_into(("u1m", "zeros", "(bucket, 32)", 0),
           ("u2m", "zeros", "(bucket, 32)", 1),
           ("q_inf", "ones", "bucket", 4), ("wrap8", "zeros", "bucket", 7)),
    *[(f"for rec in records)))\n    {nxt}", f"for rec in records)), {i})\n"
       f"    {nxt}") for nxt, i in (("qyb", 2), ("r0b", 3), ("rnb", 5))],
    ("zip(records, wraps))))\n", "zip(records, wraps))), 6)\n"))
_PACK_INTO_GLV = _replacing(
    ("bucket: int):", "bucket: int, into=None):"),
    ("range_bad, bucket)\n", "range_bad, bucket, into)\n"))
_PACK_INTO_GLV_PARTS = _replacing(
    ("bucket: int):", "bucket: int, into=None):"),
    *_into(("d1m", "zeros", "(bucket, 16)", 0),
           ("d2m", "zeros", "(bucket, 16)", 1),
           ("s1m", "zeros", "(bucket, 16)", 4),
           ("s2m", "zeros", "(bucket, 16)", 5),
           ("sg1", "zeros", "bucket", 2), ("sg2", "zeros", "bucket", 3),
           ("ydiff", "zeros", "bucket", 6),
           ("qyb", "zeros", "(bucket, 32)", 8),
           ("q_inf", "ones", "bucket", 9), ("wrap8", "zeros", "bucket", 12)),
    ("    def pad(mat: np.ndarray) -> np.ndarray:\n"
     "        out = np.zeros((bucket, 32), np.uint8)\n",
     "    def pad(mat: np.ndarray, i: int) -> np.ndarray:\n"
     "        out = _zeros(into, i, (bucket, 32))\n"),
    ("pad(qx_bytes)", "pad(qx_bytes, 7)"), ("pad(r_bytes)", "pad(r_bytes, 10)"),
    ("pad(rn_bytes)", "pad(rn_bytes, 11)"))
_PACK_INTO_MSM = _replacing(
    ("bucket: int):", "bucket: int, into=None):"),
    *_into(("xm", "zeros", "(bucket, 32)", 0),
           ("ym", "zeros", "(bucket, 32)", 1),
           ("km", "zeros", "(bucket, 32)", 3), ("inf8", "ones", "bucket", 2)))

# a layout is a list of torch devices, not a jax Mesh
_LAYOUT_MESH = _replacing(
    (") -> Mesh:", ") -> list:"),
    ("local_devices(min_count=n or 1)", "local_devices()"),
    ("return Mesh(np.array(devs), (CHIP_AXIS,))", "return devs"))


# functions of the port's own modules that keep the reference's code (the
# docstring aside) apart from the listed difference
FUNCTION_DIFFERENCES = {
    ("rpc/control", "gettpuinfo"): _torch_device_list,
    ("parallel/nonce_shard", "sweep_header_sharded"): _LAYOUT_SWEEP,
    ("parallel/sig_shard", "verify_batch_sharded"): _LAYOUT_VERIFY,
    ("parallel/sig_shard", "msm_is_infinity_sharded"): _LAYOUT_MSM,
    ("parallel/mesh", "chip_mesh"): _LAYOUT_MESH,
    ("ops/dispatch", "supervised_call"): _fallback_only_for_injected_faults,
    ("ops/ecdsa_batch", "_dispatch_msm"): _msm_oracle_only_for_injected_faults,
    ("ops/ecdsa_batch", "_dispatch_schnorr"):
        _open_breaker_oracle_only_for_injected_faults,
    ("ops/ecdsa_batch", "pallas_enabled"): _no_pallas_latch,
    ("ops/ecdsa_batch", "pack_records_w4_bytes"): _PACK_INTO_W4,
    ("ops/ecdsa_batch", "pack_records_glv"): _PACK_INTO_GLV,
    ("ops/ecdsa_batch", "_glv_pack_parts"): _PACK_INTO_GLV_PARTS,
    ("ops/ecdsa_batch", "_msm_pack"): _PACK_INTO_MSM,
}


# functions of the port's own modules that keep the reference's code as it
# is (the docstring aside): the GLV host part, what feeds the GLV legs
# (the known-answer lanes, the packed blobs; the byte emits fill kept
# buffers, a listed difference above), the bit ladder's pack, the packed
# entry (its packed_ok rule and record route), the kernel selection, the
# MSM rung's host part (the canary records, the coefficient RNG, the
# prechecks, the buckets, the canary gate and bisection, the per-lane
# oracle), and the Merkle front door (its gate and CPU confirmation)
FUNCTION_COPIES = [
    ("ops/dispatch", "merkle_root"), ("ops/dispatch", "_merkle_device_min"),
] + [("ops/ecdsa_batch", name) for name in (
    "active_kernel", "set_kernel", "pack_records", "dispatch_packed",
    "_kat_records", "records_to_blobs",
    "_schnorr_kat_records", "_msm_rng", "_schnorr_precheck",
    "_msm_bucket_for", "_msm_verify_records",
    "_schnorr_oracle")] + [("ops/secp256k1", name) for name in (
        "_round_div", "glv_split", "glv_decompose", "_np_limbs16",
        "_np_const16", "_np_mul", "_np_norm", "_np_sub", "_np_ge", "_np_dbl",
        "_np_bytes_le", "glv_split_batch_np", "glv_decompose_batch_np",
        "field_neg_bytes_np")] + [
    # the profiler RPCs (their docstrings aside; util/devicewatch's state
    # snapshot), and the sharded path's device count and dryrun
    ("rpc/control", "startprofile"), ("rpc/control", "stopprofile"),
    ("util/devicewatch", "profile_snapshot"), ("parallel/mesh", "device_count"),
    ("parallel/sig_shard", "dryrun")]


def _function_code(path: str, name: str) -> str:
    """The code of top-level function ``name`` without its docstring."""
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            if ast.get_docstring(node) is not None:
                node.body = node.body[1:]
            return ast.unparse(node) + "\n"
    raise AssertionError(f"{path} has no function {name}")


def _port_files():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import bitcoincashplus_tpu_torch.validation.chainstate\n"
        "import bitcoincashplus_tpu_torch.ops.ecdsa_batch\n"
        "import bitcoincashplus_tpu_torch.workload.sigchain\n"
        "import bitcoincashplus_tpu_torch.workload.txstorm\n"
        "import bitcoincashplus_tpu_torch.mining.generate\n"
        "import bitcoincashplus_tpu_torch.mining.resident\n"
        "import bitcoincashplus_tpu_torch.ops.merkle\n"
        "import bitcoincashplus_tpu_torch.ops.sha256\n"
        "import bitcoincashplus_tpu_torch.store.certificate\n"
        "import bitcoincashplus_tpu_torch.node.node\n"
        "import bitcoincashplus_tpu_torch.serving\n"
        "import bitcoincashplus_tpu_torch.mempool\n"
        "import bitcoincashplus_tpu_torch.store.snapshot\n"
        "import bitcoincashplus_tpu_torch.cli.bcpd\n"
        "import bitcoincashplus_tpu_torch.cli.bcp_cli\n"
        "import bitcoincashplus_tpu_torch.cli.bcp_tx\n"
        "import bitcoincashplus_tpu_torch.rpc\n"
        "import bitcoincashplus_tpu_torch.p2p\n"
        "import bitcoincashplus_tpu_torch.wallet\n"
        "import bitcoincashplus_tpu_torch.parallel.sig_shard\n"
        "import bitcoincashplus_tpu_torch.parallel.nonce_shard\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m.startswith('jaxlib')\n"
        "             or m == 'bitcoincashplus_tpu'\n"
        "             or m.startswith('bitcoincashplus_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "bitcoincashplus_tpu"), \
                f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("module", HOST_COPIES)
def test_host_copies_match_the_reference(module):
    rel = module + ".py"
    ref = open(os.path.join(REF, rel)).read()
    port = open(os.path.join(PORT, rel)).read()
    expected = DIFFERENCES.get(module, lambda s: s)(ref)
    assert port == expected, f"{rel} drifted from the JAX package"


@pytest.mark.parametrize("module,name", sorted(FUNCTION_DIFFERENCES),
                         ids=lambda x: x)
def test_own_functions_match_the_reference_but_for_listed_differences(
        module, name):
    ref = _function_code(os.path.join(REF, module + ".py"), name)
    port = _function_code(os.path.join(PORT, module + ".py"), name)
    assert port == FUNCTION_DIFFERENCES[module, name](ref), \
        f"{module}.{name} drifted from the JAX package"


@pytest.mark.parametrize("module,name", FUNCTION_COPIES, ids=lambda x: x)
def test_own_functions_copied_from_the_reference(module, name):
    ref = _function_code(os.path.join(REF, module + ".py"), name)
    port = _function_code(os.path.join(PORT, module + ".py"), name)
    assert port == ref, f"{module}.{name} drifted from the JAX package"


def test_every_listed_difference_is_still_needed():
    for module, fn in DIFFERENCES.items():
        ref = open(os.path.join(REF, module + ".py")).read()
        assert fn(ref) != ref, module
    for (module, name), fn in FUNCTION_DIFFERENCES.items():
        ref = _function_code(os.path.join(REF, module + ".py"), name)
        assert fn(ref) != ref, (module, name)


# reference host modules due to be copied byte for byte that read
# attributes of ops/ecdsa_batch (as ``ecdsa_batch`` or ``_eb``)
ECDSA_BATCH_READERS = ("serving/sigservice", "rpc/control",
                       "parallel/sig_shard")


def _ecdsa_batch_reads(path: str) -> set:
    return {node.attr for node in ast.walk(ast.parse(open(path).read(), path))
            if isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("ecdsa_batch", "_eb")}


@pytest.mark.parametrize("module", ECDSA_BATCH_READERS)
def test_reference_readers_find_what_they_read_in_the_port(module):
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch

    reads = _ecdsa_batch_reads(os.path.join(REF, module + ".py"))
    assert reads, module
    missing = sorted(n for n in reads if not hasattr(ecdsa_batch, n))
    assert not missing, f"{module} reads {missing} from ops/ecdsa_batch"


# reference modules (copied byte for byte, or pinned function by function)
# that import names from the kernel modules ops/sha256 and ops/merkle
KERNEL_MODULE_READERS = ("consensus/pow", "store/certificate",
                         "ops/dispatch")


def _kernel_module_imports(module: str) -> dict:
    """{"ops/sha256" | "ops/merkle": names} imported by the reference
    module (relative imports resolved against its package)."""
    path = os.path.join(REF, module + ".py")
    pkg = module.split("/")[:-1]
    out: dict = {}
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.ImportFrom) and node.level:
            base = pkg[:len(pkg) - (node.level - 1)]
            target = "/".join(base + (node.module or "").split("."))
            if target in ("ops/sha256", "ops/merkle"):
                out.setdefault(target, set()).update(a.name
                                                     for a in node.names)
    return out


@pytest.mark.parametrize("module", KERNEL_MODULE_READERS)
def test_reference_readers_find_the_kernel_modules_names_in_the_port(module):
    import importlib

    reads = _kernel_module_imports(module)
    assert reads, module
    for target, names in sorted(reads.items()):
        mod = importlib.import_module(
            "bitcoincashplus_tpu_torch." + target.replace("/", "."))
        missing = sorted(n for n in names if not hasattr(mod, n))
        assert not missing, f"{module} imports {missing} from {target}"


def _literal_keys(node) -> dict:
    """The keys of a dict literal, nested dict literals as sub-dicts."""
    return {k.value: _literal_keys(v) if isinstance(v, ast.Dict) else None
            for k, v in zip(node.keys, node.values)}


def _value_keys(d: dict) -> dict:
    return {k: _value_keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_kernel_info_has_the_reference_keys():
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch

    path = os.path.join(REF, "ops", "ecdsa_batch.py")
    fn = next(node for node in ast.parse(open(path).read(), path).body
              if isinstance(node, ast.FunctionDef)
              and node.name == "kernel_info")
    ret = next(node for node in ast.walk(fn) if isinstance(node, ast.Return))
    info = ecdsa_batch.kernel_info()
    assert _value_keys(info) == _literal_keys(ret.value)
    assert info["dev_decompose"]["enabled"] and ecdsa_batch.glv_enabled()
    assert not info["glv_broken"] and not info["dev_decompose"]["broken"]
    assert info["kernels"] == ["glv", "w4", "msm"]


@pytest.mark.parametrize("key,field", [
    ("schnorr_sigs", "schnorr_sigs"), ("schnorr_cpu_sigs", "schnorr_cpu_sigs"),
    ("dispatches", "msm_dispatches"),
    ("batches_accepted", "msm_batches_accepted"),
    ("batches_rejected", "msm_batches_rejected"),
    ("bisects", "msm_bisects"), ("bisect_depth_max", "msm_bisect_depth_max"),
    ("fallback_sigs", "msm_fallback_sigs"),
    ("canary_failures", "msm_canary_failures")])
def test_kernel_info_msm_keys_read_the_msm_counters(monkeypatch, key, field):
    """Each key of kernel_info()["msm"] reads its STATS counter, as the
    reference's does (its literal names the same field)."""
    from bitcoincashplus_tpu_torch.ops import ecdsa_batch

    path = os.path.join(REF, "ops", "ecdsa_batch.py")
    fn = next(node for node in ast.parse(open(path).read(), path).body
              if isinstance(node, ast.FunctionDef)
              and node.name == "kernel_info")
    ret = next(node for node in ast.walk(fn) if isinstance(node, ast.Return))
    msm = next(v for k, v in zip(ret.value.keys, ret.value.values)
               if k.value == "msm")
    ref_field = next(v.attr for k, v in zip(msm.keys, msm.values)
                     if k.value == key)
    assert ref_field == field
    monkeypatch.setattr(ecdsa_batch.STATS, field, 7)
    assert ecdsa_batch.kernel_info()["msm"][key] == 7


# the port's own modules (not copies), and the reference modules copied
# byte for byte that import names from them or read attributes of them
PORT_OWNED = ("ops/sha256", "ops/merkle", "ops/dispatch", "ops/miner",
              "ops/sha256_sweep", "ops/ecdsa_batch", "util/devicewatch",
              "mining/resident")
OWN_MODULE_READERS = ("node/node", "mempool/accept", "serving/sigservice",
                      "rpc/control")


def _own_module_reads(module: str) -> dict:
    """{port-owned module: names} the reference module reads from it:
    ``from ..ops.sha256 import backend_is_cpu`` (at top level or in a
    function), and ``alias.name`` after ``from ..util import devicewatch
    as alias`` (relative imports resolved against its package)."""
    path = os.path.join(REF, module + ".py")
    tree = ast.parse(open(path).read(), path)
    pkg = module.split("/")[:-1]
    out: dict = {}
    aliases: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            base = pkg[:len(pkg) - (node.level - 1)]
            mod = base + ([node.module.replace(".", "/")] if node.module
                          else [])
            target = "/".join(mod)
            for a in node.names:
                if target in PORT_OWNED:
                    out.setdefault(target, set()).add(a.name)
                elif f"{target}/{a.name}" in PORT_OWNED:
                    aliases[a.asname or a.name] = f"{target}/{a.name}"
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in aliases):
            out.setdefault(aliases[node.value.id], set()).add(node.attr)
    return out


@pytest.mark.parametrize("module", OWN_MODULE_READERS)
def test_reference_copies_find_what_they_read_in_the_port(module):
    """node/node (the mining engine probe ops/sha256.backend_is_cpu, the
    sweeps, -ecdsakernel's set_kernel, the packed dispatch and its STATS,
    -compilecache's devicewatch.enable_compile_cache, the WATCHDOG),
    mempool/accept, serving/sigservice and rpc/control (gettpuinfo's
    devicewatch.snapshot, the profiler RPCs' start_profile/stop_profile)
    find every name they read in the port's own modules."""
    import importlib

    reads = _own_module_reads(module)
    assert reads, module
    if module == "node/node":
        assert "backend_is_cpu" in reads["ops/sha256"]
        assert {"enable_compile_cache", "WATCHDOG"} <= \
            reads["util/devicewatch"]
        assert {"set_kernel", "dispatch_packed"} <= reads["ops/ecdsa_batch"]
    if module == "rpc/control":
        assert {"snapshot", "start_profile", "stop_profile"} <= \
            reads["util/devicewatch"]
    for target, names in sorted(reads.items()):
        mod = importlib.import_module(
            "bitcoincashplus_tpu_torch." + target.replace("/", "."))
        missing = sorted(n for n in names if not hasattr(mod, n))
        assert not missing, f"{module} reads {missing} from {target}"


def test_compile_cache_points_the_kernel_build_at_its_directory(tmp_path,
                                                                monkeypatch):
    """-compilecache=<dir>: the kernel library directory moves there
    (created), BCP_COMPILE_CACHE is seeded, and the snapshot has the
    reference's keys; a path that cannot be a directory raises OSError."""
    from bitcoincashplus_tpu_torch.ops import cuda_build
    from bitcoincashplus_tpu_torch.util import devicewatch

    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(devicewatch, "_COMPILE_CACHE",
                        {"dir": None, "enabled": False})
    monkeypatch.delenv("BCP_COMPILE_CACHE", raising=False)
    path = str(tmp_path / "cache" / "kernels")
    snap = devicewatch.enable_compile_cache(path)
    assert os.path.isdir(path) and cuda_build.BUILD_DIR == path
    assert os.environ["BCP_COMPILE_CACHE"] == path
    assert set(snap) == {"dir", "enabled", "cache_hits", "events"}
    assert snap["dir"] == path and snap["enabled"]
    assert snap == devicewatch.compile_cache_snapshot()
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        devicewatch.enable_compile_cache(str(blocker / "sub"))


def test_backend_is_cpu_follows_the_device_switch():
    from bitcoincashplus_tpu_torch.ops import cuda_build, sha256

    before = cuda_build.device()
    try:
        cuda_build.set_device("cpu")
        assert sha256.backend_is_cpu()
        cuda_build.set_device("cuda")
        assert not sha256.backend_is_cpu()
    finally:
        cuda_build.set_device(before)
