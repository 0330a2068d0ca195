"""Pre-fetch policy: the paper's two knobs, as pure logic.

The policy is deliberately free of threads, clocks and I/O so the threaded
runtime (`prefetcher.py` + `sampler.py`) and the discrete-event simulator
(`simulator.py`) share it verbatim — what the simulator predicts is what the
runtime does.

Paper semantics (§III-B, §IV-C):

  * the Sampler pulls ``fetch_size`` indices at a time from the sub-Sampler
    and announces each batch of indices to the pre-fetch service;
  * a new fetch is requested when the count of *announced but not yet
    consumed* indices drops below ``prefetch_threshold`` ("a minimum number
    of samples that have been fetched but not trained on");
  * threshold 0 is the default ("only fetches new samples when the
    Sampler's queue has been depleted");
  * the **50/50 approach**: fetch_size = prefetch_threshold = cache_size/2.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class PrefetchConfig:
    fetch_size: int
    prefetch_threshold: int = 0
    cache_items: Optional[int] = None  # None = unlimited cache
    enabled: bool = True

    def __post_init__(self) -> None:
        if self.enabled:
            if self.fetch_size < 1:
                raise ValueError("fetch_size must be >= 1")
            if self.prefetch_threshold < 0:
                raise ValueError("prefetch_threshold must be >= 0")

    @classmethod
    def fifty_fifty(cls, cache_items: int) -> "PrefetchConfig":
        """The paper's best configuration (§V-B): f = T = cache/2."""
        if cache_items < 2:
            raise ValueError("50/50 needs cache_items >= 2")
        half = cache_items // 2
        return cls(fetch_size=half, prefetch_threshold=half, cache_items=cache_items)

    @classmethod
    def full_fetch(cls, fetch_size: int) -> "PrefetchConfig":
        """'Full Fetch': cache == fetch size, threshold 0 (Fig. 9 baseline)."""
        return cls(fetch_size=fetch_size, prefetch_threshold=0, cache_items=fetch_size)

    @classmethod
    def disabled(cls) -> "PrefetchConfig":
        return cls(fetch_size=1, prefetch_threshold=0, cache_items=None, enabled=False)


class PrefetchPlanner:
    """State machine that turns a stream of sample indices into fetch rounds.

    Feed it the epoch's index order (from any sub-sampler); iterate; it
    yields ``(index, fetch_round_or_None)`` pairs: when the pending count
    crosses the threshold, the next round of ``fetch_size`` indices is
    emitted *before* the index that triggered it is consumed — mirroring the
    Sampler wrapper which requests new samples as it hands indices out.

    Invariants (property-tested):
      * every index is yielded exactly once, in sub-sampler order;
      * each index appears in exactly one fetch round before (or at) the
        step where it is consumed;
      * a round is emitted exactly when pending (announced-unconsumed)
        would otherwise drop below ``prefetch_threshold``;
      * round sizes are ``fetch_size`` except possibly the last.
    """

    #: Flight-recorder provenance (ISSUE 10): the policy family stamped on
    #: every ``issue`` event this planner's rounds produce.  The paper's
    #: knob-driven heuristics (50/50, full-fetch, threshold sweeps) all
    #: plan here.
    provenance = "paper"

    def __init__(self, order: Sequence[int], config: PrefetchConfig):
        self.order = list(order)
        self.config = config
        self.rounds_issued = 0

    def announce_schedule(self) -> List[Tuple[int, List[int]]]:
        """The epoch's fetch rounds as ``(consume_position, round)`` pairs,
        ascending in position: the round is announced immediately *before*
        the access at that position.  Purely positional — the knob-driven
        policy never inspects cache state — so the vector engine can
        precompute it and batch the demand reads between announce points
        (``repro.engine.vector``).  ``__iter__`` delegates here, keeping
        this the ONE statement of announce timing."""
        cfg = self.config
        n = len(self.order)
        schedule: List[Tuple[int, List[int]]] = []
        if not cfg.enabled:
            return schedule
        announced = 0  # prefix of `order` announced to the service
        consumed = 0
        while consumed < n:
            pending = announced - consumed
            # Announce the next round when at/below the threshold (threshold
            # 0 => only when the queue is fully depleted).
            if pending <= cfg.prefetch_threshold and announced < n:
                round_ = self.order[announced : announced + cfg.fetch_size]
                announced += len(round_)
                schedule.append((consumed, round_))
            consumed += 1
        return schedule

    def __iter__(self) -> Iterator[Tuple[int, Optional[List[int]]]]:
        rounds = {pos: round_ for pos, round_ in self.announce_schedule()}
        for consumed, idx in enumerate(self.order):
            round_ = rounds.get(consumed)
            if round_ is not None:
                self.rounds_issued += 1
            yield idx, round_

    def fetch_rounds(self) -> List[List[int]]:
        """All rounds, ignoring consumption interleaving (for cost model)."""
        return [r for _, r in self if r is not None]


def expected_rounds(n_samples: int, config: PrefetchConfig) -> int:
    """ceil(m / f) — the listing multiplier in cost Eq. 5."""
    if not config.enabled or n_samples == 0:
        return 0
    return -(-n_samples // config.fetch_size)


def validate_config_against_cache(config: PrefetchConfig) -> List[str]:
    """Lint a configuration; returns human-readable warnings.

    Encodes the paper's findings: cache < fetch size wastes fetches (§V-D
    Fig. 7); cache > fetch + threshold buys nothing; the 50/50 point is the
    recommended optimum.
    """
    warnings = []
    if not config.enabled:
        return warnings
    c = config.cache_items
    if c is not None:
        if c < config.fetch_size:
            warnings.append(
                f"cache_items={c} < fetch_size={config.fetch_size}: fetched samples "
                "evict each other before they are trained on (Fig. 7 regime)"
            )
        if config.prefetch_threshold + config.fetch_size > c:
            warnings.append(
                "threshold + fetch_size exceeds cache: an in-flight fetch can evict "
                "not-yet-consumed samples"
            )
        # `2 * fetch_size + 1` so the 50/50 construction (f = T = c // 2)
        # never trips this on an odd cache size — c = 2*(c//2) + 1 is the
        # 50/50 point itself, not excess capacity.
        if c > 2 * config.fetch_size + 1 and config.prefetch_threshold <= c // 2:
            warnings.append(
                f"cache_items={c} > 2*fetch_size: extra capacity beyond 2x fetch size "
                "does not reduce miss rate (paper Fig. 7); consider the 50/50 config"
            )
    if config.prefetch_threshold > 0 and config.prefetch_threshold < config.fetch_size // 4:
        warnings.append("very small nonzero threshold behaves like threshold=0")
    return warnings
