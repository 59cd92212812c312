"""Autoanchor in the port against the JAX package: `check_anchors` and
`kmean_anchors` bit-equal to JAX's on the synthetic set at 128 px (where
the yaml's anchors miss the 0.98 recall gate and are refit) and at 512 px
(where they pass it); the two trainers build a Detect with the same
anchors from the same arguments, and the port's loss takes them; the
port's `--noautoanchor` keeps the yaml's.

The trainers are stopped right after they build the model: their
`build_model` is wrapped to record what it built and raise."""

import numpy as np
import pytest

from sodt_tpu.data.synthetic import SyntheticVedai as JSynth
from sodt_tpu.train import trainer as jtrainer
from sodt_tpu.utils import autoanchor as jaa
from sodt_tpu_torch.data import SyntheticVedai as TSynth
from sodt_tpu_torch.train import cli, trainer as ttrainer
from sodt_tpu_torch.utils import autoanchor as taa

from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

YAML_ANCHORS = (10.0, 13.0, 16.0, 30.0, 33.0, 23.0)   # model.yaml's level
N = 64


class Built(Exception):
    """Raised by the wrapped build_model once the model exists."""


def _labels(img):
    jl, tl = JSynth(n=N, img_size=img, seed=0).labels, \
        TSynth(n=N, img_size=img, seed=0).labels
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    return tl


@pytest.mark.parametrize("img, refit", [(128, True), (512, False)])
def test_check_anchors_bit_equal_to_jax(img, refit):
    labels = _labels(img)
    shapes = np.full((N, 2), img, float)
    a0 = np.asarray(YAML_ANCHORS, np.float32).reshape(1, 3, 2)
    jn, jc, jb = jaa.check_anchors(labels, shapes, a0, img_size=img, seed=0)
    tn, tc, tb = taa.check_anchors(labels, shapes, a0, img_size=img, seed=0)
    assert (tc, tb) == (jc, jb) and tc is refit
    np.testing.assert_array_equal(tn, jn)
    if refit:
        assert not np.array_equal(tn, a0)
    else:
        assert tn is a0 and tb == 1.0


@pytest.mark.parametrize("img", [128, 512])
def test_kmean_anchors_and_metric_bit_equal_to_jax(img):
    labels = _labels(img)
    shapes = np.full((N, 2), img, float)
    kw = dict(n=6, img_size=img, thr=4.0, gen=200, seed=3)
    np.testing.assert_array_equal(taa.kmean_anchors(labels, shapes, **kw),
                                  jaa.kmean_anchors(labels, shapes, **kw))
    wh = taa.label_wh(labels, shapes, img)
    np.testing.assert_array_equal(wh, jaa.label_wh(labels, shapes, img))
    k = np.asarray(YAML_ANCHORS).reshape(3, 2)
    assert taa.anchor_metric(wh, k) == jaa.anchor_metric(wh, k)
    with pytest.raises(ValueError, match="not enough labels"):
        taa.kmean_anchors(labels[:1], shapes[:1], n=40, img_size=img)


def _jax_anchors(monkeypatch, tmp_path, **kw):
    """The anchors of the Detect that JAX's trainer builds."""
    real = jtrainer.build_model

    def wrapped(*a, **k):
        raise Built(real(*a, **k).spec.anchors)

    monkeypatch.setattr(jtrainer, "build_model", wrapped)
    tc = jtrainer.TrainConfig(cfg="sodt_tpu/configs/model.yaml",
                              synthetic=True, synthetic_n=N, img_size=128,
                              batch_size=4, save_dir=str(tmp_path / "jax"),
                              bf16=False, **kw)
    with pytest.raises(Built) as e:
        jtrainer.train(tc)
    return e.value.args[0]


def _port_model(monkeypatch, tmp_path, extra=()):
    """The model that the port's trainer builds from the CLI's flags, and
    the anchors its loss is configured with."""
    real_build, real_loss = ttrainer.build_model, ttrainer.loss_config
    seen = {}

    def build(*a, **k):
        seen["model"] = real_build(*a, **k)
        return seen["model"]

    def loss(model, hyp, nc):
        raise Built(real_loss(model, hyp, nc).anchors)

    monkeypatch.setattr(ttrainer, "build_model", build)
    monkeypatch.setattr(ttrainer, "loss_config", loss)
    with pytest.raises(Built) as e:
        cli.main(["--cfg", "configs/model.yaml", "--synthetic",
                  "--synthetic-n", str(N), "--img-size", "128",
                  "--batch-size", "4", "--no-bf16", "--device", "cpu",
                  "--save-dir", str(tmp_path / "port"), *extra])
    return seen["model"], e.value.args[0]


def test_trainers_build_the_same_refit_anchors(monkeypatch, tmp_path,
                                               capsys):
    janchors = _jax_anchors(monkeypatch, tmp_path)
    jout = capsys.readouterr().out
    model, loss_anchors = _port_model(monkeypatch, tmp_path)
    tout = capsys.readouterr().out
    assert janchors != (YAML_ANCHORS,)                     # refit at 128 px
    assert model.spec.anchors == janchors
    assert model.detect.anchors == janchors
    assert loss_anchors == janchors
    np.testing.assert_array_equal(
        model.anchors_per_level,
        np.asarray(janchors, np.float32).reshape(1, 3, 2))
    line = [l for l in jout.splitlines() if l.startswith("autoanchor")]
    assert line and line[0].endswith("-> anchors refit")
    assert line[0] in tout.splitlines()


def test_noautoanchor_keeps_the_yaml_anchors(monkeypatch, tmp_path, capsys):
    model, loss_anchors = _port_model(monkeypatch, tmp_path,
                                      ["--noautoanchor"])
    assert model.spec.anchors == loss_anchors == (YAML_ANCHORS,)
    assert "autoanchor" not in capsys.readouterr().out
    assert "--noautoanchor" in {s for act in cli.parser()._actions
                                for s in act.option_strings}
    assert _jax_anchors(monkeypatch, tmp_path, autoanchor=False) == (
        YAML_ANCHORS,)


def test_autoanchor_skipped_prints_jax_line(capsys):
    """Too few labels for the k-means: the check is skipped and the
    config's anchors kept, with JAX's message."""
    tc = ttrainer.TrainConfig(cfg="configs/model.yaml", img_size=128)
    one = [np.array([[0, 0.5, 0.5, 0.01, 0.01]], np.float32)]
    assert ttrainer.anchors_for(tc, one, {"anchor_t": 4.0}, 8) is None
    out = capsys.readouterr().out
    assert out.startswith("autoanchor skipped: not enough labels")
    kept = ttrainer.anchors_for(
        ttrainer.TrainConfig(cfg="configs/model.yaml", img_size=512),
        TSynth(n=N, img_size=512, seed=0).labels, {"anchor_t": 4.0}, 8)
    assert kept is None
    assert capsys.readouterr().out.strip() == "autoanchor: BPR 1.0000"
