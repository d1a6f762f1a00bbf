"""What the program's own spans and counters read
(``voiceactivityprojection_tpu_torch/utils/profiling.py`` ``span`` and
``count``), for the per-layer metrics of ``source`` ``program_span``.

The program records while a profiler session is active, so a traced run
holds the spans of the trace's two passes: first the calls that recorded
the device only (``ctx.profile["calls"]`` of them, the host at its own
pace), then those that recorded the host too. A reader takes the first
``ctx.profile["calls"]`` roots of the cell's root span and returns the mean
a root: the summed time of the named spans under it, or a counter. A
program without the recorder, or a run that recorded none of those spans,
reads None."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def _recorded(ctx, root: str) -> Tuple[Optional[object], List, List]:
    """(the recorder, every span, the first traced calls' roots named ``root``)."""
    if not ctx.profile:
        return None, [], []
    try:
        from voiceactivityprojection_tpu_torch.utils import profiling
    except ImportError:
        return None, [], []
    if not hasattr(profiling, "spans"):
        return None, [], []
    spans = profiling.spans()
    roots = [s for s in spans if s.parent is None and s.name == root][:int(ctx.profile["calls"])]
    return profiling, spans, roots


def span_ms(ctx, root: str, names: Sequence[str], clock: str = "device") -> Optional[float]:
    """ms a root of the spans named ``names`` under it (the root itself
    where it is named), on the ``device`` or the ``host`` clock."""
    _, spans, roots = _recorded(ctx, root)
    ids = {r.id for r in roots}
    times = [getattr(s, f"{clock}_ms") for s in spans if s.root in ids and s.name in names]
    if not roots or not times:
        return None
    return sum(times) / len(roots)


def counter(ctx, root: str, name: str, scale: float = 1.0) -> Optional[float]:
    """Counter ``name`` a root, times ``scale``."""
    profiling, _, roots = _recorded(ctx, root)
    if not roots:
        return None
    per_root = profiling.counters()
    if not any(name in per_root.get(r.id, {}) for r in roots):
        return None
    return scale * sum(per_root.get(r.id, {}).get(name, 0) for r in roots) / len(roots)
