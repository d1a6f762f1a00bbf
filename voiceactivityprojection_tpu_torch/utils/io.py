"""JSON and text files (JAX: utils/io.py:12-48).

``tensor_dict_to_json`` takes torch tensors (on any device), numpy arrays
or plain values and returns nested lists, as the JAX package's does for
its arrays.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

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
