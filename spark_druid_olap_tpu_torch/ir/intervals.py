"""Time-interval accumulation for pushdown.

Port counterpart of ``spark_druid_olap_tpu/ir/intervals.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ ``QueryIntervals.scala``: conjunctive time predicates intersect into a
single [lo, hi) milli-interval; a contradiction yields the empty interval.
Disjunctive time predicates are NOT turned into intervals (they stay filters),
matching the reference's conjunct-only extraction
(``IntervalConditionExtractor``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from spark_druid_olap_tpu_torch.ops.time_ops import date_literal_to_millis

MIN_MS = -(1 << 62)
MAX_MS = 1 << 62


@dataclasses.dataclass
class IntervalAccumulator:
    lo: int = MIN_MS
    hi: int = MAX_MS
    tz: str = "UTC"

    def _ms(self, value) -> int:
        # naive literals are session-local wall clock, zoned ones are
        # absolute instants (one policy: time_ops.literal_to_utc_millis)
        from spark_druid_olap_tpu_torch.ops.time_ops import literal_to_utc_millis
        return literal_to_utc_millis(value, self.tz)

    def ge(self, value):            # t >= v
        self.lo = max(self.lo, self._ms(value))

    def gt(self, value):            # t > v  (ms precision)
        self.lo = max(self.lo, self._ms(value) + 1)

    def le(self, value):            # t <= v
        self.hi = min(self.hi, self._ms(value) + 1)

    def lt(self, value):            # t < v
        self.hi = min(self.hi, self._ms(value))

    def eq(self, value):
        ms = self._ms(value)
        self.lo = max(self.lo, ms)
        self.hi = min(self.hi, ms + 1)

    @property
    def empty(self) -> bool:
        return self.lo >= self.hi

    def constrained(self) -> bool:
        return self.lo != MIN_MS or self.hi != MAX_MS

    def to_intervals(self) -> Optional[Tuple[Tuple[int, int], ...]]:
        if not self.constrained():
            return None
        return ((self.lo, self.hi),)
