"""The one traffic generator: statements for closed-loop clients.

A mix (``traffic/<name>.json``) says how many clients there are and how
each sends:

- ``"pattern": "refresh"``: a dashboard; each refresh sends every
  template of the configuration at once, each with fresh parameters, and
  the client waits for all of them before the next refresh;
- ``"pattern": "uniform"``: an analyst; one statement at a time, with
  fresh parameters, its template drawn uniformly: each template once in
  every round of as many statements, in a random order, so that every
  seed sends the same mix.

``"templates"`` is ``"all"`` or a list of template names. There is no
think time. Client ``c`` draws from ``numpy.random.default_rng([seed,
c])``, so a seed gives every client the same statements in the same
order. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

WARM_STREAM = 1 << 20    # rng stream of the set-up's warm-up statements
BURST = 4                # statements of one template sent at once in warm-up


def chosen(mix: dict, templates: Dict[str, object]) -> List[str]:
    names = list(templates) if mix.get("templates", "all") == "all" \
        else list(mix["templates"])
    missing = [n for n in names if n not in templates]
    if missing:
        raise KeyError(f"mix names templates the configuration lacks: "
                       f"{missing}")
    return names


def draw(tpl, rng: np.random.Generator) -> dict:
    """Fresh parameters for one statement of ``tpl``: each slot of its
    domain drawn uniformly."""
    return {k: v[int(rng.integers(len(v)))] for k, v in tpl.DOMAIN.items()}


def sql(tpl, params: dict) -> str:
    return tpl.SQL.format(**params, **tpl.derive(params)).strip()


def batch_width(mix: dict, templates: Dict[str, object]) -> int:
    """The most statements one client has in flight at once."""
    return len(chosen(mix, templates)) if mix["pattern"] == "refresh" else 1


def batches(mix: dict, templates: Dict[str, object], seed: int,
            client: int) -> Iterator[List[Tuple[str, dict]]]:
    """Client ``client``'s batches, each a list of (template, params) sent
    at once and waited for together."""
    names = chosen(mix, templates)
    rng = np.random.default_rng([seed, client])
    pattern = mix["pattern"]
    while True:
        if pattern == "refresh":
            yield [(n, draw(templates[n], rng)) for n in names]
        elif pattern == "uniform":
            for i in rng.permutation(len(names)):
                yield [(names[i], draw(templates[names[i]], rng))]
        else:
            raise ValueError(f"unknown traffic pattern {pattern!r}")


def warmup(mix: dict, templates: Dict[str, object], seed: int
           ) -> List[List[Tuple[str, dict]]]:
    """The set-up's warm-up, on a stream the window never draws from: each
    template once alone; each template as a burst of ``BURST`` statements
    at once, so that a program which coalesces concurrent statements of
    one shape builds what that shape needs (the fused kernel for a group
    whose lanes fit it); then one round of the mix's own concurrency (a
    refresh of every template per client, or one statement per client)."""
    names = chosen(mix, templates)
    rng = np.random.default_rng([seed, WARM_STREAM])
    out = [[(n, draw(templates[n], rng))] for n in names]
    out += [[(n, draw(templates[n], rng)) for _ in range(BURST)]
            for n in names]
    gen = batches(mix, templates, seed, WARM_STREAM + 1)
    rounds = [next(gen) for _ in range(int(mix["clients"]))]
    out.append([s for r in rounds for s in r])
    return out
