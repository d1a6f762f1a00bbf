"""The phrase probe's gate (JAX: data/phrases.py:286-305).

The probe itself (the phrase corpus through the model, region means of the
shift probability) is not ported yet. The gate decides as the JAX
package's does: ``phrases_probe`` 0 is off, -1 runs the probe when the
corpus CSV exists under ``phrases_root``, 1 requires it. Where the JAX
package would run the probe, this raises rather than leave the probe's
``test_*`` columns out of the metrics without a word.
"""

from __future__ import annotations

import os

PHRASE_CSV = "dataset_phrases/phrases.csv"


def make_phrase_probe(data_conf, mono: bool = False) -> None:
    """None where the JAX package builds no probe; ``FileNotFoundError``
    under ``phrases_probe=1`` without a corpus; ``NotImplementedError``
    where the JAX package would run one (for the stereo or, under ``mono``,
    the mono model)."""
    mode = int(data_conf.phrases_probe)
    if mode == 0:
        return None
    csv_path = os.path.join(data_conf.phrases_root, PHRASE_CSV)
    if not os.path.isfile(csv_path):
        if mode == 1:
            raise FileNotFoundError(f"--data_phrases_probe 1 but no phrase corpus at {csv_path}")
        return None
    raise NotImplementedError(
        f"the phrase probe over {csv_path} is not ported yet (ROADMAP Queue 1 item 8); "
        "pass --data_phrases_probe 0 to evaluate without it"
    )
