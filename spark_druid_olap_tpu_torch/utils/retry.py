"""Retry with exponential backoff.

Port of ``spark_druid_olap_tpu/utils/retry.py``: a copy kept inside the
PyTorch package, which imports nothing of the JAX package.

≈ ``RetryUtils.scala``: ``retryOnError(ifException)(name, f)(numTries, start,
cap)`` — exponential backoff used around flaky operations (in the reference:
overlord task polling, cluster metadata fetches; here: the engine's
host-to-device copies, which retry a device out-of-memory error and nothing
else, ``parallel/executor._device_copy_retry``)."""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")
log = logging.getLogger("sdot.retry")


def backoff(start: float, cap: float, attempt: int,
            prev: Optional[float] = None,
            rng: Optional[random.Random] = None) -> float:
    """Decorrelated-jitter backoff (the AWS architecture-blog variant):
    ``min(cap, uniform(start, prev * 3))``. A herd of concurrent
    retriers hitting the same failure spreads out instead of
    re-colliding on the deterministic 2^n schedule — exactly the shape
    WLM's 429 + Retry-After invites. ``prev=None`` (or a bare
    ``(start, cap, attempt)`` call — the pre-jitter signature) seeds
    the chain from the deterministic envelope, so the delay is always
    within [start, cap] and the envelope stays cap-bounded."""
    if prev is None:
        prev = min(cap, start * (2 ** attempt))
        if attempt == 0:
            return prev            # first retry stays prompt and exact
    r = rng.uniform if rng is not None else random.uniform
    return min(cap, r(start, max(start, prev * 3.0)))


def retry_on_error(
    fn: Callable[[], T],
    name: str = "operation",
    tries: int = 5,
    start: float = 0.2,
    cap: float = 5.0,
    retryable: Optional[Callable[[BaseException], bool]] = None,
) -> T:
    last: Optional[BaseException] = None
    delay: Optional[float] = None
    for attempt in range(tries):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — filtered by retryable
            if retryable is not None and not retryable(e):
                raise
            last = e
            if attempt == tries - 1:
                break
            delay = backoff(start, cap, attempt, prev=delay)
            log.warning("%s failed (attempt %d/%d): %s; retrying in %.2fs",
                        name, attempt + 1, tries, e, delay)
            time.sleep(delay)
    assert last is not None
    raise last
