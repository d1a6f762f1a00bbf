"""PyTorch port, turn-taking events and their metrics (``events/``,
``ops/codebook.py`` ``get_probs`` / ``get_da_labels``, ``EventConfig`` and
``DataConfig``) against the JAX package on the same numpy inputs: regions,
negatives, the cross-batch balance debt, targets, labels and metrics
exact; ``get_probs`` within 2e-6 (float32)."""

import argparse
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu import config as jconfig
from voiceactivityprojection_tpu.events import events as jev
from voiceactivityprojection_tpu.events import metrics as jmet
from voiceactivityprojection_tpu.events import zero_shot as jzs
from voiceactivityprojection_tpu.ops import codebook as jcb
from voiceactivityprojection_tpu.ops.vad import get_dialog_states_np as j_ds
from voiceactivityprojection_tpu_torch import config as tconfig
from voiceactivityprojection_tpu_torch.events import events as tev
from voiceactivityprojection_tpu_torch.events import metrics as tmet
from voiceactivityprojection_tpu_torch.events import zero_shot as tzs
from voiceactivityprojection_tpu_torch.ops import codebook as tcb
from voiceactivityprojection_tpu_torch.ops.vad import get_dialog_states_np as t_ds

from _torch_eval import dialog_vad

pytestmark = pytest.mark.events

PROBS_ATOL = 2e-6


def seg_vad(n_frames, segments):
    """segments: (start, end, channel) frames."""
    vad = np.zeros((n_frames, 2), dtype=np.float32)
    for s, e, c in segments:
        vad[s:e, c] = 1.0
    return vad


# hand-made VADs of the JAX package's tests (tests/test_events.py)
HS_KW = dict(pre_cond_frames=50, post_cond_frames=50, prediction_region_frames=25,
             prediction_region_on_active=True, long_onset_condition_frames=50, long_onset_region_frames=10,
             min_silence_frames=12, min_context_frames=150, max_frame=1000)
BC_KW = dict(pre_cond_frames=50, post_cond_frames=50, prediction_region_frames=25, min_context_frames=150,
             max_bc_frames=50, max_frame=1000)
NEG_KW = dict(min_pad_left_frames=50, min_pad_right_frames=100, min_region_frames=25, min_context_frames=150,
              max_frame=550)
HAND = [
    ("fill_pauses", 250, [(0, 100, 0), (120, 200, 0), (220, 250, 1)], {}),
    ("hold_shift_regions", 500, [(0, 200, 0), (220, 400, 1)], HS_KW),
    ("hold_shift_regions", 500, [(0, 200, 0), (220, 400, 0)], HS_KW),
    ("hold_shift_regions", 500, [(0, 200, 0), (220, 400, 1)], dict(HS_KW, min_context_frames=300)),
    ("hold_shift_regions", 500, [(0, 200, 0), (220, 400, 1)], dict(HS_KW, min_silence_frames=30)),
    ("hold_shift_regions", 500, [(0, 200, 0), (180, 190, 1), (220, 400, 1)], HS_KW),
    ("hold_shift_regions", 500, [(0, 200, 0), (220, 400, 1)], dict(HS_KW, max_frame=150)),
    ("hold_shift_regions", 500, [(0, 200, 0), (220, 240, 1)], dict(HS_KW, prediction_region_on_active=False)),
    ("backchannel_regions", 600, [(0, 600, 0), (200, 230, 1)], BC_KW),
    ("backchannel_regions", 600, [(0, 600, 0), (200, 300, 1)], BC_KW),
    ("get_negative_sample_regions", 600, [(0, 240, 0), (260, 500, 0)], NEG_KW),
    ("hold_shift_regions", 1000, [], HS_KW),
    ("backchannel_regions", 1000, [(0, 1000, 0), (0, 1000, 1)], BC_KW),
]


def _same(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("i", range(len(HAND)))
def test_hand_made_vad_regions_equal_jax(i):
    name, n, segments, kw = HAND[i]
    vad = seg_vad(n, segments)
    ds = t_ds(vad)
    np.testing.assert_array_equal(ds, j_ds(vad))
    _same(getattr(tev, name)(vad, ds, **kw), getattr(jev, name)(vad, ds, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_region_functions_on_random_dialog_equal_jax(seed):
    vad = dialog_vad(np.random.default_rng(seed))
    hits = 0
    for b in range(vad.shape[0]):
        ds = t_ds(vad[b])
        np.testing.assert_array_equal(tev.fill_pauses(vad[b], ds), jev.fill_pauses(vad[b], ds))
        for name, kw in (("hold_shift_regions", HS_KW), ("backchannel_regions", BC_KW),
                         ("get_negative_sample_regions", dict(NEG_KW, max_frame=1000))):
            got = getattr(tev, name)(vad[b], ds, **kw)
            assert got == getattr(jev, name)(vad[b], ds, **kw), (name, b)
            hits += sum(len(v) for v in got.values()) if isinstance(got, dict) else len(got)
        tmpl = [[0, 1, 3], [3, 1, 0], [0, 1, 0]]
        assert tev._triad_matches(ds, tmpl) == jev._triad_matches(ds, tmpl)
    assert hits > 0  # the VAD has events to extract


def _extractors(mod, conf):
    hs = mod.HoldShift(conf.sh_pre_cond_time, conf.sh_post_cond_time, conf.prediction_region_time,
                       conf.sh_prediction_region_on_active, conf.long_onset_condition_time,
                       conf.long_onset_region_time, conf.metric_time + conf.metric_pad_time,
                       conf.min_context_time, conf.max_time, conf.frame_hz)
    bc = mod.Backchannel(conf.bc_pre_cond_time, conf.bc_post_cond_time, conf.prediction_region_time,
                         conf.min_context_time, conf.bc_negative_pad_left_time, conf.bc_negative_pad_right_time,
                         conf.bc_max_duration, conf.max_time, conf.frame_hz)
    return hs, bc


@pytest.mark.parametrize("max_time", [None, 12.0])
def test_hold_shift_and_backchannel_classes_equal_jax(max_time):
    vad = dialog_vad(np.random.default_rng(3))
    (ths, tbc), (jhs, jbc) = _extractors(tev, tconfig.EventConfig()), _extractors(jev, jconfig.EventConfig())
    assert ths(vad, max_time=max_time) == jhs(vad, max_time=max_time)
    assert tbc(vad, max_time=max_time) == jbc(vad, max_time=max_time)
    import random

    neg = tbc(vad)["pred_backchannel_neg"]
    region = next(r for rows in neg for r in rows)
    t_rng, j_rng = random.Random(5), random.Random(5)
    assert [tbc.sample_negative_segment(region, t_rng) for _ in range(20)] == \
        [jbc.sample_negative_segment(region, j_rng) for _ in range(20)]


@pytest.mark.parametrize("conf_kw", [{}, {"equal_hold_shift": False}, {"prediction_region_time": 0.3,
                                                                       "min_context_time": 2.0}])
@pytest.mark.parametrize("seed", [0, 7])
def test_turn_taking_events_over_five_batches_equal_jax(seed, conf_kw):
    """Every region list and the balance debt after each of five batches
    (the negatives drawn from one ``random.Random(seed)`` in JAX's order),
    a smaller tail batch and a ``max_time`` override among them."""
    t_ex = tev.TurnTakingEvents(tconfig.EventConfig(**conf_kw), seed=seed)
    j_ex = jev.TurnTakingEvents(jconfig.EventConfig(**conf_kw), seed=seed)
    rng = np.random.default_rng(100 + seed)
    debts = [dict(t_ex.add_extra)]
    for i in range(5):
        vad = dialog_vad(rng, B=4 if i < 4 else 2)
        max_time = 15.0 if i == 2 else None
        got, want = t_ex(vad, max_time=max_time), j_ex(vad, max_time=max_time)
        assert got == want, i
        assert t_ex.add_extra == j_ex.add_extra, i
        debts.append(dict(t_ex.add_extra))
    assert t_ex.rng.getstate() == j_ex.rng.getstate()
    # a debt was carried into a later batch and paid down there
    assert any(0 < a[k] and b[k] < a[k] for a, b in zip(debts, debts[1:]) for k in a)


def test_turn_taking_events_degenerate_vads_equal_jax():
    for vad in (np.zeros((2, 1000, 2), np.float32), np.ones((1, 1000, 2), np.float32)):
        got = tev.TurnTakingEvents(tconfig.EventConfig(), seed=0)(vad)
        assert got == jev.TurnTakingEvents(jconfig.EventConfig(), seed=0)(vad)
        assert all(sum(len(b) for b in v) == 0 for v in got.values())
    with pytest.raises(ValueError, match="min_context_time"):
        tev.TurnTakingEvents(tconfig.EventConfig(min_context_time=20.0))
    with pytest.raises(ValueError, match="expected"):
        tev.TurnTakingEvents(tconfig.EventConfig())(np.zeros((1000, 2), np.float32))


def test_zero_shot_equals_jax():
    t, j = tzs.ZeroShot(), jzs.ZeroShot()
    for name in ("subset_silence", "subset_silence_hold", "subset_active", "subset_active_hold", "bc_prediction"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 300, 256)).astype(np.float32)
    va = dialog_vad(rng, B=2, T=400)
    got, want = t.get_probs(logits, va), j.get_probs(logits, va)
    assert set(got) == set(want) == {"p", "p_bc"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    for fn in ("end_of_segment_mono", "all_permutations_mono", "on_activity_change_mono"):
        np.testing.assert_array_equal(getattr(tzs, fn)(4), getattr(jzs, fn)(4))


# ------------------------------------------------------------- metrics --
def _events_and_probs(seed):
    rng = np.random.default_rng(seed)
    vad = dialog_vad(rng)
    events = jev.TurnTakingEvents(jconfig.EventConfig(), seed=seed)(vad)
    p_now = rng.random((4, 1000, 2)).astype(np.float32)
    p_fut = rng.random((4, 1000, 2)).astype(np.float32)
    return events, p_now, p_fut, rng


@pytest.mark.parametrize("with_bc", [False, True])
def test_extract_prediction_and_targets_equals_jax(with_bc):
    events, p_now, p_fut, rng = _events_and_probs(0)
    p_bc = rng.random((4, 1000, 2)).astype(np.float32) if with_bc else None
    got = tmet.extract_prediction_and_targets(p_now, p_fut, events, p_bc)
    want = jmet.extract_prediction_and_targets(p_now, p_fut, events, p_bc)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert (g[k] is None) == (w[k] is None), k
            if g[k] is not None:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["hs"] is not None and (got[0]["pred_backchannel"] is not None) == with_bc


@pytest.mark.parametrize("threshold", [None, 0.3, 0.5])
def test_binary_class_metrics_equal_jax(threshold):
    rng = np.random.default_rng(1)
    t, j = tmet.BinaryClassMetrics(), jmet.BinaryClassMetrics()
    for _ in range(3):
        probs = rng.random(500)
        probs[:20] = 0.5  # on the rounding boundary
        targets = (rng.random(500) < 0.4).astype(np.int64)
        t.update(probs, targets, threshold)
        j.update(probs, targets, threshold)
    np.testing.assert_array_equal(t.cm, j.cm)
    np.testing.assert_array_equal(t.support, j.support)
    np.testing.assert_array_equal(t.accuracy(), j.accuracy())
    assert t.f1_weighted() == j.f1_weighted()
    t.reset()
    assert t.cm.sum() == 0 and t.f1_weighted() == 0.0 and list(t.accuracy()) == [0.0, 0.0]


@pytest.mark.parametrize("thresholds", [None, {"hs": 0.45, "pred_shift": 0.6}, {"sp": 0.2, "ls": 0.7, "bp": 0.5}])
def test_event_metrics_equal_jax(thresholds):
    t, j = tmet.EventMetrics(thresholds), jmet.EventMetrics(thresholds)
    assert t.thresholds == j.thresholds
    for seed in (0, 1):
        events, p_now, p_fut, rng = _events_and_probs(seed)
        p_bc = rng.random((4, 1000, 2)).astype(np.float32)
        preds, targets = jmet.extract_prediction_and_targets(p_now, p_fut, events, p_bc)
        t.update(preds, targets)
        j.update(preds, targets)
    assert t.compute() == j.compute()
    assert t.compute()["hs_f1w"] > 0
    with pytest.raises(ValueError, match="unknown event family"):
        tmet.EventMetrics({"nope": 0.5})


# ------------------------------------------------------------- codebook --
@pytest.mark.parametrize("seed", [0, 1])
def test_get_probs_matches_jax(seed):
    logits = (3 * np.random.default_rng(seed).standard_normal((2, 200, 256))).astype(np.float32)
    got = tcb.get_probs(torch.from_numpy(logits))
    want = jcb.get_probs(jnp.asarray(logits))
    assert set(got) == set(want) == {"probs", "p_now", "p_future", "p_tot"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=PROBS_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("bin_frames", [[10, 20, 30, 40], [5, 5, 10]])
def test_get_da_labels_equals_jax(bin_frames):
    vad = dialog_vad(np.random.default_rng(4), B=2, T=600)
    vad[:, 200:350] = 0.0  # a 3 s silence: windows with no speaker
    idx, ds = tcb.get_da_labels(torch.from_numpy(vad), bin_frames)
    jidx, jds = jcb.get_da_labels(jnp.asarray(vad), bin_frames)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ds.numpy(), np.asarray(jds))
    assert set(np.unique(ds.numpy())) == {0, 1, 2}


# --------------------------------------------------------------- configs --
def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["EventConfig", "DataConfig"])
def test_config_fields_defaults_and_flags_equal_jax(name):
    t, j = getattr(tconfig, name), getattr(jconfig, name)
    assert t.PREFIX == j.PREFIX
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(t)] == \
        [(f.name, f.type, f.default) for f in dataclasses.fields(j)]
    assert _actions(t.add_argparse_args(argparse.ArgumentParser())) == \
        _actions(j.add_argparse_args(argparse.ArgumentParser()))
    assert t.args_to_conf(t.add_argparse_args(argparse.ArgumentParser()).parse_args([])) == t()


def test_data_and_event_flags_parse_as_jax():
    argv = ["--data_test_path", "t.csv", "--data_batch_size", "4", "--data_va_history_times", "30", "10",
            "--data_flip_channels", "0", "--data_phrases_probe", "0", "--event_equal_hold_shift", "0",
            "--event_max_time", "15.5"]
    for name in ("DataConfig", "EventConfig"):
        t, j = getattr(tconfig, name), getattr(jconfig, name)
        got = t.args_to_conf(t.add_argparse_args(argparse.ArgumentParser()).parse_known_args(argv)[0])
        want = j.args_to_conf(j.add_argparse_args(argparse.ArgumentParser()).parse_known_args(argv)[0])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.equal_hold_shift is False and got.max_time == 15.5
