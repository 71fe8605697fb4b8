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

import torch

from ..ops import cuda_build

# shards of the CPU layout: the reference's tests run on 8 virtual CPU
# devices
CPU_DEVICES = 8

# one stream a (card, shard slot), made at first use and kept
_STREAMS: dict = {}


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


def _stream(dev: torch.device, slot: int):
    key = (dev.index, slot)
    s = _STREAMS.get(key)
    if s is None:
        s = _STREAMS[key] = torch.cuda.Stream(dev)
    return s


def run_shards(devices: list, body, shards: list) -> list:
    """Run ``body(dev, *shards[i])`` for shard i on ``devices[i]`` and
    return the bodies' outputs once every shard has finished.

    On the CPU the shards run one after another. On CUDA devices each
    shard runs with its device current and on a stream of its own (a
    layout of one shard: the device's current stream), which first waits
    for that device's current stream; ``body`` moves its host inputs to
    ``dev`` and launches there, so copies and launch queue on that stream
    and shards do not serialise on one. The outputs are returned only
    after every shard's event has completed: a fold never reads a shard
    still in flight."""
    if len(devices) != len(shards):
        raise ValueError(f"{len(shards)} shards for {len(devices)} devices")
    if devices[0].type == "cpu":
        return [body(dev, *args) for dev, args in zip(devices, shards)]
    if len(devices) == 1:
        with torch.cuda.device(devices[0]):
            out = body(devices[0], *shards[0])
        torch.cuda.current_stream(devices[0]).synchronize()
        return [out]
    outs, events = [], []
    for slot, (dev, args) in enumerate(zip(devices, shards)):
        with torch.cuda.device(dev):
            s = _stream(dev, slot)
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                outs.append(body(dev, *args))
                events.append(torch.cuda.Event())
                events[-1].record(s)
    for ev in events:
        ev.synchronize()
    return outs
