"""CSV / TSV tables with pandas' reading and writing rules, on ``csv`` and
numpy (the port's preprocessing has no pandas).

The JAX package's preprocessing reads its inputs with ``pd.read_csv`` and
writes its artifacts with ``DataFrame.to_csv``. To write the same bytes from
the same raw files, this module keeps what those calls decide:

* a cell in pandas' default NA set is missing;
* a column's type is inferred as ``read_csv``'s C parser infers it: int
  (float where a cell is missing), bool, float, else string;
* decimal strings parse exactly as the C parser's default converter
  (``precise_xstrtod``) parses them, which is not always the correctly
  rounded double for 17-digit decimals: :func:`parse_float` follows it
  step for step (``tests/test_torch_preprocess.py`` holds it bit-equal to
  ``pd.read_csv`` and ``pd.to_numeric`` on 17-digit values);
* floats are written in their shortest round-trip form, missing cells
  empty, lines end with ``\\n``.
"""

from __future__ import annotations

import csv
import gzip
import math
import re
from dataclasses import dataclass, field
from pathlib import Path

NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT = re.compile(r"\s*[+-]?\d+\s*\Z")
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}
_INF = {"inf": math.inf, "+inf": math.inf, "infinity": math.inf,
        "+infinity": math.inf, "-inf": -math.inf, "-infinity": -math.inf}
_POW10 = [float(f"1e{k}") for k in range(309)]
_SPACE = " \t\n\r\f\v"


def parse_float(s: str) -> float | None:
    """``s`` as pandas' C parser reads a float (``precise_xstrtod``: the
    first 17 digits accumulated in a double, then one multiply or divide by
    a power of ten), or None when ``s`` is not a number."""
    inf = _INF.get(s.strip().lower())
    if inf is not None:
        return inf
    n, p = len(s), 0
    while p < n and s[p] in _SPACE:
        p += 1
    negative = p < n and s[p] == "-"
    if p < n and s[p] in "+-":
        p += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    start = p
    while p < n and "0" <= s[p] <= "9":
        if digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    seen = p > start
    if p < n and s[p] == ".":
        p += 1
        frac = p
        while digits < 17 and p < n and "0" <= s[p] <= "9":
            number = number * 10.0 + (ord(s[p]) - 48)
            p += 1
            digits += 1
            decimals += 1
        while p < n and "0" <= s[p] <= "9":
            p += 1
        seen = seen or p > frac
        exponent -= decimals
    if not seen:
        return None
    if p < n and s[p] in "eE":
        q = p + 1
        negative_exp = q < n and s[q] == "-"
        if q < n and s[q] in "+-":
            q += 1
        if q < n and "0" <= s[q] <= "9":
            e = 0
            while q < n and "0" <= s[q] <= "9":
                e = e * 10 + (ord(s[q]) - 48)
                q += 1
            exponent += -e if negative_exp else e
            p = q
    while p < n and s[p] in _SPACE:
        p += 1
    if p != n:
        return None
    if exponent > 308:
        number = math.inf
    elif exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -308:
        if exponent < -616:
            number = 0.0
        else:
            number /= _POW10[-308 - exponent]
            number /= _POW10[308]
    else:
        number /= _POW10[-exponent]
    return -number if negative else number


def to_numeric(v) -> float:
    """One cell as ``pd.to_numeric(..., errors="coerce")`` gives it."""
    if v is None or isinstance(v, bool):
        return math.nan if v is None else float(v)
    if isinstance(v, (int, float)):
        return float(v)
    x = parse_float(v)
    return math.nan if x is None else x


def is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def infer_column(cells: list) -> list:
    """Raw string cells (None = a missing field) as the values ``read_csv``
    gives the column: ints (floats where a cell is missing), bools, floats
    or strings; a missing cell is NaN."""
    na = [c is None or c in NA_VALUES for c in cells]
    present = [c for c, m in zip(cells, na) if not m]
    if not present:
        return [math.nan] * len(cells)
    if all(_INT.match(c) for c in present):
        if any(na):
            return [math.nan if m else float(int(c))
                    for c, m in zip(cells, na)]
        return [int(c) for c in cells]
    if all(c in _BOOLS for c in present):
        return [math.nan if m else _BOOLS[c] for c, m in zip(cells, na)]
    floats = []
    for c in present:
        f = parse_float(c)
        if f is None:  # a string column
            return [math.nan if m else c for c, m in zip(cells, na)]
        floats.append(f)
    it = iter(floats)
    return [math.nan if m else next(it) for m in na]


def _unify(values: list) -> list:
    """A concatenated column's values as pandas' concat leaves them: a
    column of ints and floats (or ints and missing cells) becomes float."""
    kinds = {type(v) for v in values if not is_missing(v)}
    if (kinds == {int} and any(is_missing(v) for v in values)) or \
            kinds == {int, float}:
        return [v if is_missing(v) else float(v) for v in values]
    return values


class _Columns(dict):
    """Column name -> values, each column typed (:func:`infer_column`) on
    its first access: a STAR TSV has several numeric columns and a reader
    uses one."""

    def __init__(self, raw: dict):
        super().__init__()
        self._raw = raw

    def __missing__(self, name):
        if name not in self._raw:
            raise KeyError(name)
        value = self[name] = infer_column(self._raw.pop(name))
        return value

    def __contains__(self, name):
        return name in self._raw or dict.__contains__(self, name)


@dataclass
class Table:
    """A frame: column names and one list of typed values a column."""

    columns: list
    data: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.data[self.columns[0]]) if self.columns else 0

    def column(self, name) -> list:
        return self.data[name]

    def rows(self, mask) -> "Table":
        """The rows where ``mask`` is true."""
        return Table(list(self.columns), {
            c: [v for v, keep in zip(self.data[c], mask) if keep]
            for c in self.columns})


def _lines(f, comment):
    for line in f:
        if comment is not None and comment in line:
            line = line[:line.index(comment)]
        if line.strip("\r\n"):
            yield line


def _open_text(path):
    return (gzip.open(path, "rt", newline="") if str(path).endswith(".gz")
            else open(path, newline=""))


def read_table(path_or_file, sep: str = ",",
               comment: str | None = None) -> Table:
    """``pd.read_csv(path, sep=sep, comment=comment)`` as a :class:`Table`
    (``.gz`` paths decompressed)."""
    if isinstance(path_or_file, (str, Path)):
        with _open_text(path_or_file) as f:
            return read_table(f, sep, comment)
    reader = csv.reader(_lines(path_or_file, comment), delimiter=sep)
    header = next(reader, None)
    if header is None:
        raise ValueError("no columns to parse from file")
    raw = [[] for _ in header]
    for row in reader:
        for j in range(len(header)):
            raw[j].append(row[j] if j < len(row) else None)
    return Table(list(header), _Columns(dict(zip(header, raw))))


def concat(tables: list) -> Table:
    """``pd.concat(tables, ignore_index=True)``: the union of the columns in
    order of first appearance, missing cells NaN."""
    columns = list(dict.fromkeys(c for t in tables for c in t.columns))
    data = {}
    for c in columns:
        values: list = []
        for t in tables:
            values += t.data[c] if c in t.data else [math.nan] * len(t)
        data[c] = _unify(values)
    return Table(columns, data)


def from_records(records: list) -> Table:
    """``pd.DataFrame(records)`` for a list of dicts: the union of the keys
    in order of first appearance, a missing key NaN."""
    columns = list(dict.fromkeys(k for r in records for k in r))
    return Table(columns, {c: _unify([r.get(c, math.nan) for r in records])
                           for c in columns})


def format_value(v) -> str:
    """One cell as ``to_csv`` writes it: missing empty, floats in their
    shortest round-trip form, bools True/False."""
    if is_missing(v):
        return ""
    if isinstance(v, float):
        return repr(v)
    return str(v)


def write_csv(path, header: list, rows) -> None:
    """Write a header and rows of values as ``to_csv`` would."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        for row in rows:
            w.writerow([format_value(v) for v in row])


def write_table(path, table: Table) -> None:
    """``table.to_csv(path, index=False)``."""
    write_csv(path, table.columns,
              zip(*(table.data[c] for c in table.columns)))
