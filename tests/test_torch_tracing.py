"""The port's spans and counters (segclip_tpu_torch/utils/profiling.py) on
the CPU: nothing recorded, and no `record_function` reached, without a
profiler; spans on kineto's clock under one; parents and self time; the
training step's and the sharded evaluator's spans and counts; and the
benchmark's readers of them (portbench/metrics) on synthetic stretches."""
import time

import numpy as np
import pytest
import torch

from portbench.lib import manifest
from portbench.lib.trace import Interval, Summary
from segclip_tpu_torch.config import Config, ModelConfig
from segclip_tpu_torch.evalseg.inference import ZeroShotSegmenter, evaluate_dataset_sharded
from segclip_tpu_torch.models.segclip import init_segclip
from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step
from segclip_tpu_torch.utils import profiling

TINY = ModelConfig(image_resolution=32, vision_patch_size=8, vision_width=64, vision_layers=4,
                   first_stage_layer=3, group_num=4, cross_layer=1, context_length=16,
                   vocab_size=512, transformer_width=64, transformer_layers=2, embed_dim=32,
                   compute_dtype="float32", max_words=16, mae_decoder_depth=1,
                   mae_decoder_num_heads=2)


def cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def test_without_a_profiler_a_span_records_nothing_and_skips_record_function(
        fresh, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function reached with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("a", unit=3, device=True):
        with profiling.span("b"):
            torch.ones(4).add_(1)
    assert profiling.spans() == []


def test_a_span_holds_the_kineto_interval_of_its_work(fresh):
    x = torch.ones(4)
    with cpu_profile() as prof:
        with profiling.span("outer"):
            x.add_(1)
    [s] = profiling.spans()
    [add] = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::add_"]
    assert s.start_ns <= add.start_ns() <= add.start_ns() + add.duration_ns() <= s.end_ns
    assert "outer" in {e.name() for e in prof.profiler.kineto_results.events()}


def test_nesting_gives_parents_and_self_time(fresh):
    with cpu_profile():
        with profiling.span("outer", unit=7):
            time.sleep(0.004)
            with profiling.span("inner"):
                time.sleep(0.002)
            with profiling.span("inner"):
                with profiling.span("leaf"):
                    time.sleep(0.001)
    outer, inner1, inner2, leaf = profiling.spans()
    assert [s.name for s in (outer, inner1, inner2, leaf)] == ["outer", "inner", "inner", "leaf"]
    assert (outer.parent, inner1.parent, inner2.parent, leaf.parent) == (None, 0, 0, 2)
    assert outer.unit == 7 and outer.device_ms is None
    for child, parent in ((inner1, outer), (inner2, outer), (leaf, inner2)):
        assert parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns
    assert inner1.end_ns <= inner2.start_ns
    children = (inner1.end_ns - inner1.start_ns) + (inner2.end_ns - inner2.start_ns)
    own = outer.end_ns - outer.start_ns - children
    assert 0.004e9 <= own < outer.end_ns - outer.start_ns


def test_an_exception_closes_the_span(fresh):
    with cpu_profile():
        with pytest.raises(KeyError):
            with profiling.span("outer"):
                with profiling.span("raises"):
                    raise KeyError("window end")
        with profiling.span("after"):
            pass
    outer, raised, after = profiling.spans()
    assert raised.end_ns is not None and outer.end_ns is not None
    assert after.parent is None


def test_counters_add_up_and_read_the_launch_counters_in_place():
    from segclip_tpu_torch.ops.kernels import attention, grouping
    before = profiling.counters()
    profiling.count("test.things")
    profiling.count("test.things", 4)
    after = profiling.counters()
    assert after["test.things"] - before.get("test.things", 0) == 5
    assert after["attention.launches"] == attention.attention.launches
    assert after["attention_bwd_one_pass.launches"] == attention.attention_bwd_one_pass.launches
    assert after["group_assign_st.launches"] == grouping.group_assign_st.launches
    assert profiling.counters()["attention.launches"] == attention.attention.launches


def tiny_batch(rng, b=2):
    ids = np.zeros((b, 16), np.int64)
    ids[:, 0], ids[:, 1:4], ids[:, 4] = 509, rng.integers(1, 500, (b, 3)), 511
    return {"input_ids": torch.from_numpy(ids),
            "attention_mask": torch.from_numpy(ids != 0).long(),
            "image": torch.from_numpy(rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)),
            "image_seg": torch.from_numpy(rng.integers(0, 4, (b, 4, 4)))}


def test_a_training_step_records_its_phases_once_each_in_order(fresh):
    cfg = Config(model=TINY)
    model = init_segclip(cfg.model, seed=0)
    step = make_train_step(model, create_optimizer(model, cfg, t_total=10), cfg)
    batch, state = tiny_batch(np.random.default_rng(0)), TrainState(step=5)
    before = profiling.counters()
    with cpu_profile():
        step(state, batch)
    after = profiling.counters()
    # the normalisation's two constants, the loss's logit-scale cap, the NaN check
    assert after["host_syncs"] - before.get("host_syncs", 0) == 4
    assert after["train.steps"] - before.get("train.steps", 0) == 1
    got = profiling.spans()
    assert [s.name for s in got] == ["train.step", "train.normalize", "train.forward",
                                     "train.backward", "train.clip", "train.nan_check",
                                     "train.optimizer"]
    assert got[0].unit == 5 and got[0].parent is None
    assert all(s.parent == 0 for s in got[1:])
    assert all(a.end_ns <= b.start_ns for a, b in zip(got[1:], got[2:]))
    assert all(s.device_ms is None for s in got)            # on the CPU: no CUDA events


class Spec:
    ignore_index = 255
    classes = ("background", "a", "b", "c", "d", "e")


class Images:
    """A dataset of seeded images (not at the crop's size) with labels."""

    def __init__(self, shapes, seed=0):
        rng = np.random.default_rng(seed)
        self.spec = Spec()
        self.samples = []
        for h0, w0 in shapes:
            img = rng.normal(size=(40, 48, 3)).astype(np.float32)
            label = rng.integers(0, 6, (h0, w0)).astype(np.int64)
            self.samples.append(type("Sample", (), dict(image=img, label=label,
                                                        orig_shape=(h0, w0))))

    def __len__(self):
        return len(self.samples)

    def load(self, i):
        return self.samples[i]


def test_the_sharded_evaluator_records_each_image_and_counts_its_syncs_and_builds(fresh):
    model = init_segclip(TINY, seed=0).eval()
    bank = torch.nn.functional.normalize(torch.randn(5, 32, generator=torch.Generator()
                                                     .manual_seed(0)), dim=-1)
    seg = ZeroShotSegmenter(model, bank, with_bg=True, bg_thresh=0.5, patch_size=8,
                            crop_size=32, stride=32)
    data = Images([(50, 60), (45, 70), (60, 50), (44, 52)])
    before = profiling.counters()
    with cpu_profile():
        evaluate_dataset_sharded(seg, data, images_per_device=2)
    after = profiling.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("host_syncs", "interp_builds", "eval.images")}
    # two matrices an image (the labels' resize) and two a group (the
    # attention's upsample); a sync for each matrix's copy, for each group's
    # crops' copy and for each image's .cpu()
    builds = 4 * 2 + 2 * 2
    assert delta == {"host_syncs": builds + 2 + 4, "interp_builds": builds, "eval.images": 4}
    got = profiling.spans()
    names = [s.name for s in got]
    group = ["eval.group", "eval.prep", "eval.prep", "eval.encode", "eval.decode"]
    image = ["eval.stitch", "eval.labels"]
    want = (["eval.load"] * 2 + group + image * 2 + ["eval.meter"] * 2) * 2
    assert names == want
    for s in got:
        assert (s.parent is None) == (s.name in ("eval.load", "eval.group"))
        if s.parent is not None:
            assert got[s.parent].name == "eval.group"


def syn(name, parent, start, end, device_ms=None):
    return profiling.Span(name, parent, None, start, end, device_ms)


# A device stretch (100, 1100) of 2 steps: busy [100, 300], [400, 700],
# [900, 1000]; gaps (300, 400), (700, 900), (1000, 1100).
TRAIN_SPANS = [
    syn("train.forward", None, 0, 90, 7.0),               # closes before the stretch
    syn("train.step", None, 90, 1050),
    syn("train.forward", 1, 120, 320, 0.2),
    syn("train.backward", 1, 330, 600, 0.5),
    syn("train.clip", 1, 610, 750, 0.05),
    syn("train.nan_check", 1, 750, 800),
    syn("train.optimizer", 1, 820, 1040, 0.3),
    syn("train.forward", None, 1060, 1200, 9.0),          # closes after it
]
TRAIN_CTX = {"kind": "pretrain", "units_profiled": 2,
             "summary": Summary((100, 1100), [Interval("k", 100, 300), Interval("k", 400, 700),
                                              Interval("k", 900, 1000)], [])}
# gap (300, 400): forward 20, step 10, backward 70; (700, 900): clip 50,
# nan_check 50, step 20, optimizer 80; (1000, 1100): optimizer 40, step 10,
# no span 10, the next forward 40.
# Eval, 2 images: busy [0, 160], [300, 350], [800, 1000]; gaps (160, 300)
# and (350, 800).
EVAL_SPANS = [
    syn("eval.prep", None, 0, 50), syn("eval.encode", None, 50, 120),
    syn("eval.decode", None, 120, 150), syn("eval.stitch", None, 150, 170),
    syn("eval.labels", None, 170, 250), syn("eval.meter", None, 250, 320),
    syn("eval.stitch", None, 320, 330), syn("eval.labels", None, 330, 500),
    syn("eval.meter", None, 500, 600), syn("eval.load", None, 600, 650),
    syn("eval.load", None, 650, 700),
]
EVAL_CTX = {"kind": "zeroshot_eval", "units_profiled": 2,
            "summary": Summary((0, 1000), [Interval("k", 0, 160), Interval("k", 300, 350),
                                           Interval("k", 800, 1000)], [])}
# gap (160, 300): stitch 10, labels 80, meter 50; (350, 800): labels 150,
# meter 100, load 100, no span 100.
COUNTS = {"host_syncs": 34, "train.steps": 34, "eval.images": 34, "interp_builds": 34 * 2.125}

READINGS = [
    ("forward_ms.train", TRAIN_CTX, TRAIN_SPANS, 0.2 / 2),
    ("backward_ms.train", TRAIN_CTX, TRAIN_SPANS, 0.5 / 2),
    ("optimizer_ms.train", TRAIN_CTX, TRAIN_SPANS, (0.05 + 0.3) / 2),
    ("optimizer_idle_ms.train", TRAIN_CTX, TRAIN_SPANS, (50 + 50 + 80 + 40) / 2 * 1e-6),
    ("host_syncs.train", TRAIN_CTX, TRAIN_SPANS, 1.0),
    ("labels_idle_ms.eval", EVAL_CTX, EVAL_SPANS, (80 + 150) / 2 * 1e-6),
    ("meter_idle_ms.eval", EVAL_CTX, EVAL_SPANS, (50 + 100) / 2 * 1e-6),
    ("prep_idle_ms.eval", EVAL_CTX, EVAL_SPANS, 100 / 2 * 1e-6),
    ("host_syncs.eval", EVAL_CTX, EVAL_SPANS, 1.0),
    ("interp_builds.eval", EVAL_CTX, EVAL_SPANS, 2.125),
]


@pytest.mark.parametrize("name,ctx,spans,want", READINGS, ids=[r[0] for r in READINGS])
def test_a_reader_gives_the_hand_computed_value(name, ctx, spans, want, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTS))
    got = manifest.reader(name)(ctx)
    assert got == pytest.approx(want, rel=1e-12)
    other = TRAIN_CTX if ctx is EVAL_CTX else EVAL_CTX
    assert manifest.reader(name)(other) is None              # another cell's kind


@pytest.mark.parametrize("name", [r[0] for r in READINGS])
def test_a_reader_gives_none_on_a_program_without_spans(name, monkeypatch):
    """The parent of the spans: utils/profiling without spans() and
    counters(); and a stretch in which no span of the metric closed."""
    ctx = TRAIN_CTX if name.endswith(".train") else EVAL_CTX
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert manifest.reader(name)(ctx) is None


def test_idle_splits_gaps_across_the_innermost_span_and_leaves_the_rest_to_none():
    from portbench.lib import spans
    under = spans.idle_under(spans.gaps(TRAIN_CTX["summary"]), TRAIN_SPANS, (100, 1100))
    assert under == {"train.forward": 20 + 40, "train.step": 10 + 20 + 10,
                     "train.backward": 70, "train.clip": 50, "train.nan_check": 50,
                     "train.optimizer": 80 + 40, None: 10}
    assert sum(under.values()) == 100 + 200 + 100
