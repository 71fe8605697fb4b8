"""BIP9 versionbits deployment state machine.

Reference: src/versionbits.{h,cpp} (AbstractThresholdConditionChecker,
ThresholdState, VersionBitsState/ComputeBlockVersion) and the warning
plumbing in src/validation.cpp:~2200 (unknown-version upgrade warning).

The reference walks one MTP-gated period state machine per deployment:
DEFINED -> STARTED (start_time reached) -> LOCKED_IN (threshold of the
period signalled) -> ACTIVE, with STARTED -> FAILED on timeout. States are
a pure function of the period-boundary ancestor, memoized per boundary
block. The same machine here is a free function over CBlockIndex with an
explicit cache dict — no inheritance hierarchy; the per-deployment
`condition` is just the default bit test unless a caller overrides it.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Callable, Optional

VERSIONBITS_TOP_BITS = 0x20000000
VERSIONBITS_TOP_MASK = 0xE0000000
VERSIONBITS_NUM_BITS = 29

# start_time sentinels (consensus/params.h)
ALWAYS_ACTIVE = -1
NO_TIMEOUT = 1 << 62


class ThresholdState(Enum):
    DEFINED = "defined"
    STARTED = "started"
    LOCKED_IN = "locked_in"
    ACTIVE = "active"
    FAILED = "failed"


@dataclass(frozen=True)
class VBDeployment:
    """Consensus::BIP9Deployment (src/consensus/params.h)."""

    name: str
    bit: int
    start_time: int
    timeout: int


def default_condition(index, dep: VBDeployment) -> bool:
    """Condition(pindex): version signals TOP_BITS scheme + deployment bit."""
    v = index.header.version
    return (
        (v & VERSIONBITS_TOP_MASK) == VERSIONBITS_TOP_BITS
        and (v >> dep.bit) & 1 == 1
    )


def get_state_for(
    dep: VBDeployment,
    prev_index,  # CBlockIndex | None: block BEFORE the one being evaluated
    window: int,
    threshold: int,
    cache: Optional[dict] = None,
    condition: Callable = default_condition,
) -> ThresholdState:
    """AbstractThresholdConditionChecker::GetStateFor (versionbits.cpp:~10).

    State for the block AFTER prev_index. `cache` memoizes period-boundary
    states keyed by boundary block hash (VersionBitsCache entry)."""
    if dep.start_time == ALWAYS_ACTIVE:
        return ThresholdState.ACTIVE

    # walk prev back to the last period boundary (height % window == window-1)
    if prev_index is not None:
        prev_index = prev_index.get_ancestor(
            prev_index.height - ((prev_index.height + 1) % window)
        )

    # collect boundary ancestors until a cached/terminal state
    to_compute = []
    while prev_index is not None and (cache is None or prev_index.hash not in cache):
        if prev_index.get_median_time_past() < dep.start_time:
            # optimization from the reference: before start_time the state
            # is DEFINED; cache and stop walking
            if cache is not None:
                cache[prev_index.hash] = ThresholdState.DEFINED
            break
        to_compute.append(prev_index)
        prev_index = prev_index.get_ancestor(prev_index.height - window)

    if prev_index is None:
        state = ThresholdState.DEFINED
    elif cache is not None and prev_index.hash in cache:
        state = cache[prev_index.hash]
    else:
        state = ThresholdState.DEFINED  # the pre-start boundary found above

    # apply the state machine forward over the walked periods
    while to_compute:
        idx = to_compute.pop()
        if state == ThresholdState.DEFINED:
            if idx.get_median_time_past() >= dep.timeout:
                state = ThresholdState.FAILED
            elif idx.get_median_time_past() >= dep.start_time:
                state = ThresholdState.STARTED
        elif state == ThresholdState.STARTED:
            if idx.get_median_time_past() >= dep.timeout:
                state = ThresholdState.FAILED
            else:
                # count signalling blocks over the period ending at idx
                count = 0
                walk = idx
                for _ in range(window):
                    if walk is None:
                        break
                    if condition(walk, dep):
                        count += 1
                    walk = walk.prev
                if count >= threshold:
                    state = ThresholdState.LOCKED_IN
        elif state == ThresholdState.LOCKED_IN:
            state = ThresholdState.ACTIVE
        # ACTIVE and FAILED are terminal
        if cache is not None:
            cache[idx.hash] = state
    return state


def get_state_since_height(
    dep: VBDeployment, prev_index, window: int, threshold: int,
    cache: Optional[dict] = None,
) -> int:
    """GetStateSinceHeightFor: first height at which the current state
    applies (0 for DEFINED-from-genesis)."""
    state = get_state_for(dep, prev_index, window, threshold, cache)
    if state == ThresholdState.DEFINED:
        return 0
    # walk period boundaries backwards while the state is unchanged
    idx = prev_index
    if idx is not None:
        idx = idx.get_ancestor(idx.height - ((idx.height + 1) % window))
    while idx is not None:
        prev_boundary = idx.get_ancestor(idx.height - window)
        if get_state_for(dep, prev_boundary, window, threshold, cache) != state:
            break
        idx = prev_boundary
    return 0 if idx is None else idx.height + 1


class VersionBitsCache:
    """VersionBitsCache (versionbits.h): per-deployment boundary memo."""

    def __init__(self):
        self._per_dep: dict[str, dict] = {}

    def for_dep(self, dep: VBDeployment) -> dict:
        return self._per_dep.setdefault(dep.name, {})

    def clear(self):
        self._per_dep.clear()


def compute_block_version(prev_index, deployments, window: int,
                          threshold: int,
                          cache: Optional[VersionBitsCache] = None) -> int:
    """ComputeBlockVersion (src/miner.cpp:~60 / versionbits.cpp): TOP_BITS
    plus every deployment bit in STARTED or LOCKED_IN."""
    version = VERSIONBITS_TOP_BITS
    for dep in deployments:
        state = get_state_for(
            dep, prev_index, window, threshold,
            cache.for_dep(dep) if cache is not None else None,
        )
        if state in (ThresholdState.STARTED, ThresholdState.LOCKED_IN):
            version |= 1 << dep.bit
    return version


def unknown_version_signalling(tip, deployments, window: int) -> int:
    """The validation.cpp:~2200 upgrade warning: count of the last `window`
    blocks whose version uses the TOP_BITS scheme with bits outside every
    known deployment (a possible unknown soft fork signalling)."""
    known_mask = 0
    for dep in deployments:
        known_mask |= 1 << dep.bit
    count = 0
    idx = tip
    for _ in range(min(window, 100)):
        if idx is None:
            break
        v = idx.header.version
        if (
            (v & VERSIONBITS_TOP_MASK) == VERSIONBITS_TOP_BITS
            and v & ~(VERSIONBITS_TOP_MASK | known_mask) & ((1 << VERSIONBITS_NUM_BITS) - 1)
        ):
            count += 1
        idx = idx.prev
    return count
