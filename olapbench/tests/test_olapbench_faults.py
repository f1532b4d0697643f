"""The comparison that decides ``correct`` fails what it has to fail.

- The control: the plain reference computed in float32 put in the
  program's place (``control.py``) comes out not correct, at a scale a
  test run can hold (the chip run reads it at the cells' own scale).
- A run whose timed path is broken underneath comes out not correct:
  an answer's values altered, half of an answer's groups left out,
  and every answer handed to the next statement (a demultiplexing
  fault), each where the server produces the answer. Each drives a whole run on the CPU,
  the look for a card skipped.
"""

import pytest

from conftest import SEED
from olapbench import control, run

CONTROL_SCALE = {"ssb_sf1.dashboard": 0.2}


@pytest.mark.parametrize("workload", sorted(CONTROL_SCALE))
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(bench, workload, seed):
    v = control.control(bench, workload, seed, 1000,
                        scale=CONTROL_SCALE[workload])
    assert v["correct"] is False
    assert v["numbers"]["wrong_answers"]["value"] > 0


def _alter_values(df):
    """Integers one off, floats off by a share of 1e-5."""
    out = df.copy()
    for c in out.columns:
        if out[c].dtype.kind == "f":
            out[c] = out[c] * (1 + 1e-5)
        elif out[c].dtype.kind in "iu":
            out[c] = out[c] + 1
    return out


def _drop_half(df):
    return df.iloc[: len(df) // 2]       # a one-row answer loses its row


class _Previous:
    """Hands each statement the answer of the one before it."""

    def __init__(self):
        self.last = None

    def __call__(self, df):
        prev, self.last = self.last, df
        return df if prev is None else prev


FAULTS = {"values_altered": lambda: _alter_values,
          "half_the_groups": lambda: _drop_half,
          "answer_of_another": _Previous}


@pytest.mark.parametrize("workload", ["ssb_sf1.dashboard"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(bench, monkeypatch, workload, fault):
    from spark_druid_olap_tpu_torch.server import http
    alter = FAULTS[fault]()
    real = http._df_to_json_rows
    monkeypatch.setattr(http, "_df_to_json_rows",
                        lambda df: real(alter(df)))
    line = run.run_cell(bench, workload, SEED, 1.0, False, device="cpu",
                        scale=0.01)
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["wrong_answers"]["value"] > 0


def test_a_refused_statement_is_not_correct():
    """A 429 (the admission control shedding load) fails ``refused``."""
    from olapbench import compare
    results = {"texts": ["select 1"], "bodies": {}, "records": [
        {"template": "q1_1", "params": {}, "text": 0, "status": 429,
         "body": ""}]}
    v = compare.check(None, {}, results, SEED, {})
    assert v["correct"] is False
    assert v["numbers"]["refused"]["value"] == 1
    assert v["numbers"]["unanswered"]["value"] == 0
