"""The port's ``utils/retry.py`` against the JAX package's.

The six cases of ``tests/test_retry.py`` run through both packages:
decorrelated-jitter backoff bounds, the cap-bounded envelope, diverging
retriers and the retry loop. Each case also holds the port's delays equal
to the JAX package's on the same seeded random streams.
"""

import random

import pytest

from spark_druid_olap_tpu.utils import retry as JR

from spark_druid_olap_tpu_torch.utils import retry as TR
from spark_druid_olap_tpu_torch.utils.retry import backoff, retry_on_error


def test_backoff_legacy_signature_first_attempt_exact():
    # the pre-jitter (start, cap, attempt) call keeps a prompt, exact
    # first retry
    assert backoff(0.2, 5.0, 0) == pytest.approx(0.2)
    assert backoff(0.2, 5.0, 0) == JR.backoff(0.2, 5.0, 0)


def test_backoff_always_within_start_cap():
    runs = {}
    for mod in (TR, JR):
        rng = random.Random(1234)
        seen = runs[mod] = []
        for start, cap in [(0.2, 5.0), (0.01, 0.5), (1.0, 1.0)]:
            prev = None
            for attempt in range(12):
                d = mod.backoff(start, cap, attempt, prev=prev, rng=rng)
                assert start <= d <= cap, (start, cap, attempt, d)
                prev = d
                seen.append(d)
    assert runs[TR] == runs[JR]


def test_backoff_envelope_monotone_and_cap_bounded():
    # drive the jitter to its upper edge: the envelope must grow
    # monotonically and saturate at cap, never beyond
    class _Top:
        @staticmethod
        def uniform(a, b):
            return b

    runs = {}
    for mod in (TR, JR):
        prev = None
        seen = []
        for attempt in range(10):
            prev = mod.backoff(0.2, 5.0, attempt, prev=prev, rng=_Top())
            seen.append(prev)
        assert seen == sorted(seen)
        assert seen[-1] == pytest.approx(5.0)
        assert all(d <= 5.0 for d in seen)
        runs[mod] = seen
    assert runs[TR] == runs[JR]


def test_backoff_decorrelates_concurrent_retriers():
    # two retriers with different rng streams diverge (no herd lockstep)
    a = [None]
    b = [None]
    ra, rb = random.Random(1), random.Random(2)
    sa, sb = [], []
    for attempt in range(6):
        a[0] = backoff(0.2, 5.0, attempt, prev=a[0], rng=ra)
        b[0] = backoff(0.2, 5.0, attempt, prev=b[0], rng=rb)
        sa.append(a[0])
        sb.append(b[0])
    assert sa[1:] != sb[1:]     # attempt 0 is deterministic by design


def test_retry_on_error_retries_then_raises(monkeypatch):
    sleeps = []
    monkeypatch.setattr("time.sleep", lambda s: sleeps.append(s))
    calls = []

    def flaky():
        calls.append(1)
        raise OSError("down")

    with pytest.raises(OSError):
        retry_on_error(flaky, "flaky", tries=4, start=0.01, cap=0.05)
    assert len(calls) == 4
    assert len(sleeps) == 3
    assert all(0.01 <= s <= 0.05 for s in sleeps)


def test_retry_on_error_nonretryable_raises_immediately():
    for mod in (TR, JR):
        calls = []

        def bad():
            calls.append(1)
            raise ValueError("logic bug")

        with pytest.raises(ValueError):
            mod.retry_on_error(bad, tries=5,
                               retryable=lambda e: isinstance(e, OSError))
        assert len(calls) == 1
