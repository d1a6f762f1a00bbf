"""Load and summarise the JSON that the ``run`` CLI writes (JAX: root
load_output.py; reference load_stereo.py).

    python -m voiceactivityprojection_tpu_torch.load_output out.json

``load_np`` returns every output as a numpy array (``vad_list`` stays a
list); the command prints each key's shape and dtype.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from voiceactivityprojection_tpu_torch.utils.io import read_json


def load_np(path: str) -> dict:
    d = read_json(path)
    for k, v in d.items():
        if k == "vad_list":
            continue
        d[k] = np.array(v)
    return d


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m voiceactivityprojection_tpu_torch.load_output <output.json>")
        return 0
    path = argv[0]
    d = load_np(path)
    print("-" * 50)
    print(path)
    print("-" * len(path))
    for k, v in d.items():
        if isinstance(v, np.ndarray):
            print(f"{k}: {tuple(v.shape)} {v.dtype}")
        else:
            print(f"{k}: {type(v).__name__}")
    print("-" * 50)
    return 0


if __name__ == "__main__":
    sys.exit(main())
