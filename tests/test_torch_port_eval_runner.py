"""The whole-pass eval of the port (`sodt_tpu_torch/train/evaluate.py`:
`EvalRunner`, `_try_scan_eval`, `evaluate(scan=, runner=, stack_cache=,
cache_bias=, loss_cfg=)`) against its per-batch path and the JAX
package's `evaluate`, f32 on the CPU.

Models: `tests/tiny.yaml` (the all-CNN detector, nc 3, 64 px) unless a
test says otherwise; the narrow flagship (`NARROW_CFG`, nc 3) where the
cached rel-pos biases must follow a weight change; the in-repo trained
checkpoint at 256 px against JAX's scan eval.

Bounds: the whole pass against the per-batch path, one runner against
the runnerless path, `stack_cache` and `approx_topk`: equal (detections
bit for bit, metrics exactly); against JAX's scan eval on the checkpoint:
mAP and mAP@0.5 within 5e-3 and `nt` equal (the bound of
`tests/test_torch_port_eval.py`); the val loss within 1e-5 relative of
JAX's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches
from sodt_tpu_torch.models import build_model
from sodt_tpu_torch.train import evaluate as tev
from sodt_tpu_torch.train.evaluate import EvalRunner, evaluate
from sodt_tpu_torch.weights import init_weights

from torch_port_common import NARROW_CFG
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
TINY = str(ROOT / "tests/tiny.yaml")
KW = dict(nc=3, img_size=64, top_k=256, max_det=50, device="cpu")
MAP_TOL = 5e-3
LOSS_REL = 1e-5


def tiny(seed: int = 2, obj_bias: float = 8.0):
    """The tiny CNN, seeded, its objectness biases raised so that every
    image has candidates above conf 0.001."""
    m = build_model(TINY, ch_in=3, nc=3, input_mode="RGB").eval()
    init_weights(m, seed=seed)
    with torch.no_grad():
        m.detect.m0.bias.view(-1, 8)[:, 4] += obj_bias
    return m


def narrow(seed: int):
    m = build_model(NARROW_CFG, ch_in=4, nc=3).eval()
    init_weights(m, seed=seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if "relative_position_bias_table" in name:
                p.normal_(0, 0.5, generator=torch.Generator().manual_seed(
                    seed))
        m.detect.m0.bias.view(-1, 8)[:, 4] += 8.0
    return m


def batches(n: int = 8, bs: int = 2, img: int = 64, seed: int = 0):
    return make_eval_batches(SyntheticVedai(n=n, img_size=img, nc=3,
                                            seed=seed), bs, img)


def same_metrics(a: dict, b: dict) -> None:
    keys = set(a) - {"speed_ms"}
    assert keys == set(b) - {"speed_ms"}
    for k in keys:
        assert a[k] == b[k], (k, a[k], b[k])


class Spy:
    """Counts the whole-pass runners built (`_make_scan_runner`) and the
    passes they run."""

    def __init__(self, monkeypatch):
        self.built = self.passes = 0
        real = tev._make_scan_runner

        def make(step):
            self.built += 1
            run = real(step)

            def counted(*a):
                self.passes += 1
                return run(*a)
            return counted
        monkeypatch.setattr(tev, "_make_scan_runner", make)


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid"])
def test_whole_pass_equals_per_batch(hybrid):
    """JAX's test_evaluate_scan_matches_per_batch: the metrics exactly
    equal, and each batch's detections from the pass bit-equal to its
    step's on the per-batch path (also with hybrid labels, whose ground
    truth rides into the pass on the device). The AP of a seeded model is
    0 here; the checkpoint case below holds it where it is not."""
    m = tiny()
    kw = dict(KW, save_hybrid=hybrid)
    whole = evaluate(m, batches(), scan=True, **kw)
    per = evaluate(m, batches(), scan=False, **kw)
    assert whole["seen"] == per["seen"] == 8
    same_metrics(whole, per)
    step = tev.make_eval_step(m, top_k=256, max_det=50, hybrid_labels=hybrid)
    got, t_pass = tev._try_scan_eval(step, batches(), True,
                                     torch.device("cpu"))
    assert t_pass is not None
    for b in got:
        d, v, _ = b["_results"]
        t = lambda k: torch.from_numpy(b[k])
        rd, rv, _ = step(t("img"), t("ir"), t("targets"), t("tmask"))
        np.testing.assert_array_equal(d, rd.numpy())
        np.testing.assert_array_equal(v, rv.numpy())
        assert v.any()


def test_whole_pass_matches_jax_scan_on_checkpoint():
    """The trained flagship at 256 px on SyntheticVedai(n=4, seed=1),
    batch 2: the port's whole pass against JAX's `evaluate(scan=True)`
    (mAP and mAP@0.5 within 5e-3, nt equal) and against the port's own
    per-batch path (equal)."""
    import jax
    from sodt_tpu.data.loader import make_eval_batches as jbatches
    from sodt_tpu.data.synthetic import SyntheticVedai as JSynth
    from sodt_tpu.train.evaluate import evaluate as jevaluate
    from torch_port_common import trained_pair
    jm, v, tm = trained_pair()
    img = 256
    mj = jevaluate(jm, jax.tree.map(jax.numpy.asarray, v),
                   jbatches(JSynth(n=4, img_size=img, seed=1), 2, img),
                   nc=8, img_size=img, scan=True)
    tb = lambda: make_eval_batches(SyntheticVedai(n=4, img_size=img, seed=1),
                                   2, img)
    mt = evaluate(tm, tb(), nc=8, img_size=img, device="cpu", scan=True)
    mp = evaluate(tm, tb(), nc=8, img_size=img, device="cpu", scan=False)
    same_metrics(mt, mp)
    assert mt["seen"] == mj["seen"] == 4
    assert mt["nt"] == mj["nt"]
    assert mj["map50"] > 0.5
    for k in ("map50", "map"):
        assert abs(mt[k] - mj[k]) <= MAP_TOL, (k, mt[k], mj[k])


def test_runner_reuses_its_pass_and_equals_runnerless(monkeypatch):
    """JAX's test_evaluate_runner_reuses_compiled_programs: one runner
    builds its whole-pass runner once (`scan_fn()` returns the same object
    on every call) and its metrics equal the runnerless path's."""
    spy = Spy(monkeypatch)
    m = tiny()
    runner = EvalRunner(tiny(seed=9), top_k=256, max_det=50)
    m1 = evaluate(m, batches(), runner=runner, **KW)
    fn = runner.scan_fn()
    m2 = evaluate(m, batches(), runner=runner, **KW)
    assert runner.scan_fn() is fn and spy.built == 1
    m0 = evaluate(m, batches(), **KW)
    assert spy.built == 2 and spy.passes == 3
    same_metrics(m1, m0)
    same_metrics(m2, m0)


def test_runner_follows_a_weight_change():
    """One runner over two weight sets of the narrow flagship (its rel-pos
    tables drawn): each call equals a runnerless `evaluate` of the weights
    passed to it, exactly, and so do the second set's detections from the
    runner's pass, batch by batch; the runner's module keeps its cached
    biases' and parameters' addresses (refreshed in place)."""
    a, b = narrow(0), narrow(2)
    kw = dict(KW, img_size=64)
    bt = lambda: batches(n=4, img=64)
    runner = EvalRunner(narrow(5), top_k=256, max_det=50)
    own = runner.model
    ptrs = lambda: [t.data_ptr() for t in
                    [x for x in own.parameters()]
                    + [mm.bias_cache for mm in own.modules()
                       if getattr(mm, "bias_cache", None) is not None]]
    ra = evaluate(a, bt(), runner=runner, **kw)
    before = ptrs()
    rb = evaluate(b.state_dict(), bt(), runner=runner, **kw)
    assert ptrs() == before
    same_metrics(ra, evaluate(a, bt(), **kw))
    same_metrics(rb, evaluate(b, bt(), **kw))
    got, _ = tev._try_scan_eval(runner.step, bt(), True,
                                torch.device("cpu"), runner)
    step_a = tev.make_eval_step(a, top_k=256, max_det=50)
    step_b = tev.make_eval_step(b, top_k=256, max_det=50)
    for batch in got:
        x = [torch.from_numpy(batch[k]) for k in ("img", "ir")]
        d, v, _ = batch["_results"]
        db, vb, _ = step_b(*x)
        np.testing.assert_array_equal(d, db.numpy())
        np.testing.assert_array_equal(v, vb.numpy())
        assert v.any()
        assert not torch.equal(step_a(*x)[0], db)
    # the runner's module now holds b's weights and b's biases
    for mm, mb in zip(own.modules(), b.modules()):
        if getattr(mm, "bias_cache", None) is not None:
            assert torch.equal(mm.bias_cache, mb.materialize_bias())


def test_runner_rejects_another_protocol():
    """JAX's test_evaluate_rejects_mismatched_runner_protocol."""
    runner = EvalRunner(tiny(), top_k=256, max_det=50)
    with pytest.raises(ValueError, match="conf_thres"):
        evaluate(tiny(), batches(n=4), conf_thres=0.25, runner=runner, **KW)
    assert evaluate(tiny(), batches(n=4), runner=runner, **KW)["seen"] == 4


def test_stack_cache_leaves_its_iterator_untouched():
    """JAX's test_evaluate_stack_cache_matches_and_skips_rebuild: under the
    same key the second call does not touch its batches, and every call
    gives the metrics of the uncached path."""
    m = tiny()
    runner = EvalRunner(tiny(seed=3), top_k=256, max_det=50)
    m0 = evaluate(m, batches(), **KW)
    m1 = evaluate(m, batches(), runner=runner, stack_cache="val", **KW)
    assert "val" in runner._stacks
    blist = runner._stacks["val"][0]
    assert not any({"img", "ir"} & set(b) for b in blist)
    consumed = []

    def poisoned():
        for b in batches():
            consumed.append(1)
            yield b
    m2 = evaluate(m, poisoned(), runner=runner, stack_cache="val", **KW)
    assert not consumed
    same_metrics(m0, m1)
    same_metrics(m0, m2)
    assert m2["seen"] == 8


def _mixed_shapes():
    """Two batches of different shapes (as rect batches have)."""
    a = next(batches(n=2, img=64))
    b = next(batches(n=2, img=96))
    b["net_shape"] = (96, 96)
    return iter([a, b])


@pytest.mark.parametrize("case", ["rect", "single", "scan_false",
                                  "over_budget", "forced"])
def test_eligibility(case, monkeypatch):
    """The per-batch path for mixed shapes (rect), a single batch,
    `scan=False` and an auto estimate over the budget; `scan=True` takes
    the whole pass over the budget too."""
    spy = Spy(monkeypatch)
    monkeypatch.setattr(tev, "SCAN_BUDGET_BYTES", 1000.0)
    src, scan = {"rect": (_mixed_shapes, None),
                 "single": (lambda: batches(n=2), None),
                 "scan_false": (batches, False),
                 "over_budget": (batches, None),
                 "forced": (batches, True)}[case]
    got = evaluate(tiny(), src(), scan=scan, **KW)
    assert spy.passes == (case == "forced")
    if case in ("rect", "single"):
        assert got["seen"] == 4 if case == "rect" else 2
    else:
        monkeypatch.setattr(tev, "SCAN_BUDGET_BYTES", 1e9)
        same_metrics(got, evaluate(tiny(), src(), scan=not scan, **KW))
        assert spy.passes == 1


def test_val_loss_matches_jax():
    """`loss_cfg` fills `val_loss` (the mean of the batches' losses) on
    the whole pass and the per-batch path, equal to each other and within
    1e-5 relative of JAX's on the same drawn weights."""
    import jax
    from sodt_tpu.data.loader import make_eval_batches as jbatches
    from sodt_tpu.data.synthetic import SyntheticVedai as JSynth
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.train.evaluate import evaluate as jevaluate
    from sodt_tpu.train.loss import LossConfig as JLossConfig
    from sodt_tpu_torch.train.loss import LossConfig
    from sodt_tpu_torch.weights import from_jax_variables
    from torch_port_common import drawn_variables

    jm = jbuild(TINY, ch_in=3, input_mode="RGB")
    x0 = np.zeros((2, 64, 64, 3), np.float32)
    v = drawn_variables(jm, x0, x0, seed=4)
    m = build_model(TINY, ch_in=3, nc=3, input_mode="RGB").eval()
    m.load_state_dict(from_jax_variables(v))
    hyp = dict(hyp_box=0.05, hyp_obj=1.0, hyp_cls=0.5)
    jcfg = JLossConfig(nc=3, anchors=jm.spec.anchors,
                       strides=jm.spec.detect_strides, **hyp)
    tcfg = LossConfig(nc=3, anchors=m.spec.anchors,
                      strides=m.spec.detect_strides, **hyp)
    mj = jevaluate(jm, jax.tree.map(jax.numpy.asarray, v),
                   jbatches(JSynth(n=6, img_size=64, nc=3), 2, 64),
                   nc=3, img_size=64, top_k=256, max_det=50, loss_cfg=jcfg,
                   scan=False)
    whole = evaluate(m, batches(n=6), loss_cfg=tcfg, scan=True, **KW)
    per = evaluate(m, batches(n=6), loss_cfg=tcfg, scan=False, **KW)
    assert whole["val_loss"] == per["val_loss"]
    assert set(per["val_loss"]) == set(mj["val_loss"]) == {"box", "obj",
                                                           "cls"}
    for k, want in mj["val_loss"].items():
        assert abs(per["val_loss"][k] - want) <= LOSS_REL * abs(want), (
            k, per["val_loss"][k], want)
    assert "val_loss" not in evaluate(m, batches(n=6), **KW)


def test_approx_topk_gives_the_same_results():
    """`make_eval_step(approx_topk=True)` keeps the exact stable sort: the
    same detections, and a runner built with it the same metrics."""
    m = tiny()
    b = next(batches(n=2))
    x = [torch.from_numpy(b[k]) for k in ("img", "ir")]
    d0, v0, _ = tev.make_eval_step(m, top_k=256, max_det=50)(*x)
    d1, v1, _ = tev.make_eval_step(m, top_k=256, max_det=50,
                                   approx_topk=True)(*x)
    assert torch.equal(d0, d1) and torch.equal(v0, v1)
    runner = EvalRunner(tiny(), top_k=256, max_det=50, approx_topk=True)
    assert runner.step_kw["approx_topk"] is True
    same_metrics(evaluate(m, batches(), runner=runner, **KW),
                 evaluate(m, batches(), **KW))


def test_cache_bias_false_skips_the_cache(monkeypatch):
    """`cache_bias=False` does not call `cache_rel_bias`, with or without
    a runner; the metrics are the cached path's."""
    calls = []
    real = tev.cache_rel_bias
    monkeypatch.setattr(tev, "cache_rel_bias",
                        lambda m: calls.append(1) or real(m))
    a = narrow(0)
    kw = dict(KW, img_size=64)
    m0 = evaluate(a, batches(n=4), **kw)
    assert calls == [1]
    m1 = evaluate(a, batches(n=4), cache_bias=False, **kw)
    runner = EvalRunner(narrow(2), top_k=256, max_det=50)
    m2 = evaluate(a, batches(n=4), cache_bias=False, runner=runner, **kw)
    assert calls == [1]
    same_metrics(m0, m1)
    same_metrics(m0, m2)


def test_val_cli_takes_the_whole_pass_by_default(tmp_path, monkeypatch):
    """`python -m sodt_tpu_torch.val` on several batches takes the whole
    pass (JAX's val.py calls evaluate with scan None); a single batch
    stays per batch."""
    from sodt_tpu_torch import val
    spy = Spy(monkeypatch)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(yaml.safe_load(open(TINY))))
    args = ["--cfg", str(cfg), "--input_mode", "RGB", "--task", "val",
            "--synthetic", "--synthetic-n", "4", "--img-size", "64",
            "--no-bf16", "--device", "cpu", "--save-dir", str(tmp_path)]
    m = val.main(args + ["--batch-size", "2"])
    assert spy.passes == 1 and m["seen"] == 4
    val.main(args + ["--batch-size", "4"])
    assert spy.passes == 1
