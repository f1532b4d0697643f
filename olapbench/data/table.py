"""One generated flat star, held for both sides of the comparison.

The program gets :meth:`Table.frame`: numbers as numpy columns, dates as
``datetime64[ns]``, strings as Arrow-backed columns (as a frame read from
Parquet with the Arrow backend holds them). The plain reference reads
:meth:`Table.col`: numbers as they were drawn, dates as days since the
epoch, strings as codes into a vocabulary sorted ascending, so that a
string's order is its code's order. A column drawn per dimension row and
gathered onto the fact rows keeps its dimension array and the gather index,
and the reference gathers it only when a statement reads it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc

EPOCH = np.datetime64("1970-01-01", "D")


class Column:
    """One flat column: ``base[index]`` (or ``base`` when ``index`` is
    None). ``kind`` is ``int``, ``float``, ``date``, ``str`` (codes into the
    sorted ``vocab``) or ``text`` (an Arrow string array the reference never
    reads: comments and other unique-per-row strings)."""

    __slots__ = ("kind", "base", "index", "vocab", "text")

    def __init__(self, kind: str, base=None, index=None, vocab=None,
                 text=None):
        self.kind, self.base, self.index = kind, base, index
        self.vocab, self.text = vocab, text

    def values(self) -> np.ndarray:
        return self.base if self.index is None else self.base[self.index]


def sorted_vocab(words) -> tuple:
    """``(vocab sorted ascending, remap)``: ``remap[i]`` is the sorted code
    of ``words[i]``."""
    words = np.asarray(words, dtype=str)
    order = np.argsort(words, kind="stable")
    remap = np.empty(len(words), np.int32)
    remap[order] = np.arange(len(words), dtype=np.int32)
    return words[order], remap


class Table:
    """The flat rows of one deployment, in the column order of its frame."""

    def __init__(self, name: str, n_rows: int, time_column: str):
        self.name, self.n_rows, self.time_column = name, n_rows, time_column
        self.columns: Dict[str, Column] = {}
        self._cache: Dict[str, np.ndarray] = {}

    # -- building -----------------------------------------------------------
    def add(self, name: str, kind: str, base, index=None) -> None:
        self.columns[name] = Column(kind, np.asarray(base), index)

    def add_words(self, name: str, words, codes, index=None) -> None:
        """A string column drawn as ``words[codes]`` (``codes`` per base
        row, gathered by ``index`` when given)."""
        vocab, remap = sorted_vocab(words)
        self.columns[name] = Column("str", remap[np.asarray(codes)], index,
                                    vocab=vocab)

    def add_text(self, name: str, text: pa.Array, index=None) -> None:
        self.columns[name] = Column("text", index=index, text=text)

    # -- the program's side -------------------------------------------------
    def frame(self) -> pd.DataFrame:
        out = {}
        for name, c in self.columns.items():
            if c.kind == "str":
                arr = pc.take(pa.array(c.vocab, pa.string()),
                              pa.array(self.col(name)))
                out[name] = pd.Series(arr, dtype=pd.ArrowDtype(pa.string()))
            elif c.kind == "text":
                arr = c.text if c.index is None \
                    else pc.take(c.text, pa.array(c.index))
                out[name] = pd.Series(arr, dtype=pd.ArrowDtype(pa.string()))
            elif c.kind == "date":
                out[name] = (EPOCH + c.values().astype("timedelta64[D]")
                             ).astype("datetime64[ns]")
            else:
                out[name] = c.values()
        return pd.DataFrame(out)

    # -- the reference's side -----------------------------------------------
    def col(self, name: str) -> np.ndarray:
        """Values (numbers, days, or string codes) over every flat row."""
        got = self._cache.get(name)
        if got is None:
            c = self.columns[name]
            if c.kind == "text":
                raise KeyError(f"{name}: a text column has no codes")
            got = self._cache[name] = c.values()
        return got

    def kind(self, name: str) -> str:
        return self.columns[name].kind

    def vocab(self, name: str) -> np.ndarray:
        return self.columns[name].vocab

    def code(self, name: str, value: str) -> int:
        """The code of ``value`` in ``name``'s vocabulary, -1 if absent."""
        v = self.columns[name].vocab
        i = int(np.searchsorted(v, value))
        return i if i < len(v) and v[i] == value else -1

    def code_range(self, name: str, lo: str, hi: str) -> tuple:
        """Codes ``[a, b)`` of the strings ``lo <= s <= hi``."""
        v = self.columns[name].vocab
        return (int(np.searchsorted(v, lo, side="left")),
                int(np.searchsorted(v, hi, side="right")))
