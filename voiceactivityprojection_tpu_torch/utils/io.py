"""JSON, text and CSV files (JAX: utils/io.py:12-48).

``tensor_dict_to_json`` takes torch tensors (on any device), numpy arrays
or plain values and returns nested lists, as the JAX package's does for
its arrays. ``read_csv`` reads a table as the JAX package's pandas calls
do, without pandas (absent on the card's machine).
"""

from __future__ import annotations

import ast
import csv
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def write_json(data: Any, filename: str) -> None:
    with open(filename, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False)


def read_json(path: str, encoding: str = "utf8") -> Any:
    with open(path, "r", encoding=encoding) as f:
        return json.loads(f.read())


def write_txt(txt: List[str], name: str) -> None:
    with open(name, "w") as f:
        f.write("\n".join(txt))


def read_txt(path: str, encoding: str = "utf-8") -> List[str]:
    with open(path, "r", encoding=encoding) as f:
        return [line.strip() for line in f.readlines()]


def tensor_dict_to_json(d: Dict[str, Any]) -> Dict[str, Any]:
    """Tensors and arrays of a (nested) dict as nested lists."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = tensor_dict_to_json(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy().tolist()
        elif hasattr(v, "tolist"):
            out[k] = np.asarray(v).tolist()
        else:
            out[k] = v
    return out


def _column_type(values: List[str]):
    """int, float or str for one CSV column, as pandas infers it: integers
    (an empty cell makes the column float), numbers, else text."""
    filled = [v for v in values if v != ""]
    for cast in (int, float):
        try:
            for v in filled:
                cast(v)
        except ValueError:
            continue
        return float if cast is int and len(filled) < len(values) else cast
    return str


def read_csv(path: str, literal: Sequence[str] = (), fieldnames: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    """A CSV file as a list of row dicts in the file's order, as
    ``pandas.read_csv`` types it: a column of integers ``int``, of numbers
    ``float``, any other ``str``, an empty cell NaN; the ``literal`` columns
    parsed by ``ast.literal_eval`` (pandas' ``converters``). ``fieldnames``
    names the columns of a file without a header (a short row's missing
    cells empty)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f, fieldnames=fieldnames, restval=""))
    if not rows:
        return []
    types = {c: _column_type([r[c] for r in rows]) for c in rows[0] if c not in literal}

    def parse(col: str, v: str):
        if col in literal:
            return ast.literal_eval(v)
        return float("nan") if v == "" else types[col](v)

    return [{c: parse(c, v) for c, v in r.items()} for r in rows]
