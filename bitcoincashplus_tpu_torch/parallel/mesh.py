"""Device layouts for the sharded paths (parallel/sig_shard.py,
parallel/nonce_shard.py).

Port of the reference's parallel/mesh.py. There a 1-D ``jax.sharding.Mesh``
over the ('chip',) axis carried a ``shard_map``; here a layout is a plain
list of ``torch.device``s, one per shard, and a sharded program is one
launch of an already ported kernel per shard (``run_shards``), folded on
the host as the reference's collectives did.

- Under the CUDA switch (the default) ``local_devices()`` is every card,
  ``cuda:0`` … ``cuda:{torch.cuda.device_count() - 1}``; with no card it
  raises ``KernelUnavailable`` (``ops/cuda_build.require_device``) and
  never falls back to the CPU.
- Under ``cuda_build.set_device("cpu")`` (the tests) it is the CPU
  CPU_DEVICES times: the counterpart of the reference's virtual CPU mesh
  under its tests (``xla_force_host_platform_device_count=8``).
- A caller may hand the sharded entry points a layout of its own
  (``devices=``): ``[cuda:0] * 4`` puts four shards on one card, each on
  a stream of its own.

The reference's ``shard_map_nocheck`` has no counterpart: nothing here
traces a program, so there is no replication check to turn off.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..ops import cuda_build

# shards of the CPU layout: the reference's tests run on 8 virtual CPU
# devices
CPU_DEVICES = 8

# one stream a (card, shard slot), made at first use and kept
_STREAMS: dict = {}

# The parts of the sharded calls, when a caller asks for them (chip_smoke.py's
# breakdown sets PARTS to {}): host seconds by part ("pack", "stage",
# "submit", "wait", "copy_back", "fold", "recheck") summed over the calls
# since, and under "kernel_ms" each shard's launch span on its stream from
# CUDA events. None, the default: nothing is recorded.
PARTS = None
_SPANS: list = []


def note(part: str, t0: float) -> float:
    """Add the host seconds since ``t0`` to PARTS[part] when recording;
    returns the clock's reading, the next part's start."""
    t = time.perf_counter()
    if PARTS is not None:
        PARTS[part] = PARTS.get(part, 0.0) + t - t0
    return t


@contextlib.contextmanager
def kernel_span(dev):
    """Bracket a launch with timing events on ``dev``'s current stream
    when recording (resolved into PARTS["kernel_ms"] by ``spans_done``)."""
    if PARTS is None or dev.type != "cuda":
        yield
        return
    s = torch.cuda.current_stream(dev)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record(s)
    yield
    b.record(s)
    _SPANS.append((a, b))


def spans_done() -> None:
    """Move the finished launch spans into PARTS["kernel_ms"]."""
    if PARTS is not None:
        PARTS.setdefault("kernel_ms", []).extend(
            a.elapsed_time(b) for a, b in _SPANS)
    _SPANS.clear()


def local_devices() -> list:
    """The devices a layout is cut from: every card under the CUDA
    switch (KernelUnavailable with none), the CPU CPU_DEVICES times under
    the CPU switch."""
    dev = cuda_build.require_device("the device layout")
    if dev.type == "cpu":
        return [torch.device("cpu")] * CPU_DEVICES
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_count() -> int:
    return len(local_devices())


def chip_mesh(n: int | None = None) -> list:
    """Layout over the first n local devices (default: all)."""
    devs = local_devices()
    if n is not None:
        if n > len(devs):
            raise ValueError(f"requested {n} devices, have {len(devs)}")
        devs = devs[:n]
    return devs


def layout(n_chips: int | None, devices) -> list:
    """The layout of a sharded call: ``devices`` when given (its width
    must be n_chips, where that is given too), else ``chip_mesh(n_chips)``."""
    if devices is None:
        return chip_mesh(n_chips)
    devices = [torch.device(d) for d in devices]
    if not devices or (n_chips is not None and len(devices) != n_chips):
        raise ValueError(f"a layout of {len(devices)} devices for "
                         f"{n_chips} shards")
    return devices


def shard_streams(devices: list) -> list:
    """(stream, event) of each shard of a CUDA layout: at width 1 the
    device's current stream, the unsharded call's own; else one stream a
    (card, slot), made once and kept. One event a (card, slot), kept."""
    out = []
    for slot, dev in enumerate(devices):
        key = (dev.index, slot)
        kept = _STREAMS.get(key)
        if kept is None:
            kept = _STREAMS[key] = (torch.cuda.Stream(dev), torch.cuda.Event())
        stream = (torch.cuda.current_stream(dev) if len(devices) == 1
                  else kept[0])
        out.append((stream, kept[1]))
    return out


def _current_streams(devices: list) -> list:
    """The current stream of each card of a layout, the current card's
    last: setting them back (``_set_streams``) puts back each card's
    stream and, with the last, the current card."""
    cards = {d.index: d for d in devices}
    return [torch.cuda.current_stream(d) for d in cards.values()] + [
        torch.cuda.current_stream()]


def _set_streams(streams: list) -> None:
    """Make each stream current on its card (and its card current)."""
    for s in streams:
        torch.cuda.set_stream(s)


def _same(dev, *args):
    return args


def _kept(dev, out):
    return out


def run_shards(devices: list, launch, shards: list, stage=_same,
               collect=_kept) -> list:
    """Queue every shard's work, wait for all of it, and return each
    shard's output.

    For shard i on ``devices[i]``: ``stage(dev, *shards[i])`` queues its
    copies in and returns ``launch``'s arguments (by default the shard
    itself); ``launch(dev, *args)`` queues its kernel; ``collect(dev,
    out)`` queues the copies of its outputs to host buffers and returns
    the shard's output (by default ``launch``'s). Every shard's copies in
    are queued before any launch, so the cards' copy engines start
    together, and every shard's launch and copies out before any wait:
    nothing synchronises between two shards' submissions. The outputs are
    returned once every shard's event has completed.

    On the CPU the three run one after another, shard by shard. On CUDA
    devices shard i queues on ``shard_streams(devices)[i]``, made current
    while it queues: at width 1 the card's current stream (on the current
    card nothing is switched, and the wait is on the shard's event, not on
    the card); else a stream a (card, slot). A shard's work reads only what it stages from the host and
    what was made once and synchronised (the GLV comb), so its stream
    waits on no other. On an error every stream is drained before it is
    raised: no copy is left reading a host buffer that the next call
    refills."""
    if len(devices) != len(shards):
        raise ValueError(f"{len(shards)} shards for {len(devices)} devices")
    if devices[0].type == "cpu":
        return [collect(dev, launch(dev, *stage(dev, *args)))
                for dev, args in zip(devices, shards)]
    lanes = shard_streams(devices)
    # a layout of the current card alone queues on its current stream;
    # else each shard's stream is made current while its work is queued
    # (a launch may read the current stream: a CUDA graph's replay), and
    # the cards' current streams are put back after
    switch = len(devices) > 1 or \
        devices[0].index != torch.cuda.current_device()
    back = _current_streams(devices) if switch else []
    use = _set_streams if switch else (lambda streams: None)
    try:
        t0 = time.perf_counter()
        staged = []
        for dev, (s, _ev), args in zip(devices, lanes, shards):
            use([s])
            staged.append(stage(dev, *args))
        t0 = note("stage", t0)
        outs = []
        for dev, (s, ev), args in zip(devices, lanes, staged):
            use([s])
            with kernel_span(dev):
                out = launch(dev, *args)
            outs.append(collect(dev, out))
            ev.record(s)
        t0 = note("submit", t0)
        for _s, ev in lanes:
            ev.synchronize()
        note("wait", t0)
    except BaseException:
        for s, _ev in lanes:
            s.synchronize()
        raise
    finally:
        _set_streams(back)
        spans_done()
    return outs
