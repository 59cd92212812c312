"""sodt_tpu_torch.data.loader and utils.general against the JAX package on
the CPU: the bank feed's index schedule (also image-weighted), the
multi-scale resize, the label weights and --single-cls; and the port's own
feed contracts (both regimes give the same batches, `start_step` resumes
the stream, the bank gate)."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sodt_tpu.data import loader as jl
from sodt_tpu.data.synthetic import SyntheticVedai as JSynth
from sodt_tpu.data.vedai import apply_single_cls as japply
from sodt_tpu.utils import general as jg
from sodt_tpu_torch.data import SyntheticVedai, apply_single_cls
from sodt_tpu_torch.data import loader as tl
from sodt_tpu_torch.utils import general as tg

S = 32
HYP = dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=0.0, translate=0.1,
           scale=0.5, shear=0.0, perspective=0.0, flipud=0.0, fliplr=0.5,
           mosaic=1.0, mixup=0.5)


def _weights_fn(ds, nc=8):
    maps = np.linspace(0.1, 0.9, nc)
    cw = jg.labels_to_class_weights(ds.labels, nc) * (1 - maps) ** 2 / nc
    return lambda: jg.labels_to_image_weights(ds.labels, nc, cw)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["permutation", "image_weights"])
def test_bank_schedule_matches_jax(weighted):
    """prim / sec of every step over three epochs, for the same seed."""
    n, b = 12, 4
    jds, tds = JSynth(n=n, img_size=S, seed=0), SyntheticVedai(n=n,
                                                                img_size=S,
                                                                seed=0)
    fn = _weights_fn(jds) if weighted else None
    jf = jl.BankFeed(jds, b, S, HYP, seed=5, sample_weights_fn=fn,
                     prefer_native=False)
    tf = tl.BankFeed(tds, b, S, HYP, seed=5, sample_weights_fn=fn,
                     device="cpu")
    for _ in range(3 * jf.steps_per_epoch):
        jp, js, _ = jf.step_schedule()
        tp, ts, d = tf.step_schedule()
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ts, js)
        assert d.shape == (b, 69)
    # the banks hold the same tiles and padded labels
    for jb, tb in zip(jf.banks, tf.banks):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_label_weights_and_single_cls_match_jax():
    ds = SyntheticVedai(n=9, img_size=S, seed=2)
    cw = tg.labels_to_class_weights(ds.labels, 8)
    np.testing.assert_array_equal(cw, jg.labels_to_class_weights(ds.labels, 8))
    np.testing.assert_array_equal(
        tg.labels_to_image_weights(ds.labels, 8, cw),
        jg.labels_to_image_weights(ds.labels, 8, cw))
    jds = JSynth(n=9, img_size=S, seed=2)
    apply_single_cls(ds)
    japply(jds)
    for a, b in zip(ds.labels, jds.labels):
        np.testing.assert_array_equal(a, b)
        assert (a[:, 0] == 0).all()
    np.testing.assert_array_equal(ds[3][0], jds[3][0])


@pytest.mark.parametrize("size", [36, 48, 60])
def test_multi_scale_resize_matches_jax(size):
    """The buckets' resize (0.75 / 1 / 1.25) against jax.image.resize's
    antialiased bilinear, f32."""
    x = np.random.default_rng(0).uniform(0, 1, (2, 48, 48, 3)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, size, size, 3), "bilinear")
    got = (tl.resize_bilinear(torch.from_numpy(x), size) if size != 48
           else torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def _take(it, k):
    return [next(it) for _ in range(k)]


def _same(a, b):
    for x, y in zip(a, b):
        for k in ("img", "ir", "targets", "tmask"):
            assert torch.equal(x[k], y[k]), k


def test_regimes_agree_and_start_step_resumes_the_stream(monkeypatch):
    """The device bank and the streaming regime give the same batches for
    the same seed; a feed started at step k gives the batches that the
    uninterrupted feed gives from k on (draws, schedule and the
    multi-scale stream are run forward), in both regimes. The regime is
    set through the bank gate, DEVICE_BANK_MAX_GB."""
    s = 96                    # buckets 64, 96, 128 px
    ds = SyntheticVedai(n=8, img_size=s, seed=1)
    kw = dict(seed=3, device="cpu", multi_scale=True,
              sample_weights_fn=_weights_fn(ds))
    gate = {"bank": tl.DEVICE_BANK_MAX_GB, "stream": 0.0}

    def batches(regime, k, **more):
        monkeypatch.setattr(tl, "DEVICE_BANK_MAX_GB", gate[regime])
        return _take(tl.make_train_batches(ds, 2, s, HYP, **kw, **more), k)
    bank, stream = batches("bank", 9), batches("stream", 9)
    _same(bank, stream)
    assert {b["img"].shape[1] for b in bank} == {64, 96, 128}
    for regime in gate:
        late = batches(regime, 4, start_step=5)
        _same(late, bank[5:])
        assert [b["epoch"] for b in late] == [1, 1, 1, 2]


def test_bank_gate(monkeypatch):
    """The bank when the rgb + ir tiles fit DEVICE_BANK_MAX_GB, streaming
    when they do not; streaming batches as the trainer takes them."""
    ds = SyntheticVedai(n=4, img_size=S, seed=1)
    fits = 2 * 4 * S * S * 3 / 2**30                       # GB of tiles
    monkeypatch.setattr(tl, "DEVICE_BANK_MAX_GB", fits)
    assert tl.make_bank_feed(ds, 2, S, HYP, device="cpu") is not None
    monkeypatch.setattr(tl, "DEVICE_BANK_MAX_GB", fits * 0.99)
    assert tl.make_bank_feed(ds, 2, S, HYP, device="cpu") is None
    b = next(tl.make_train_batches(ds, 2, S, HYP, device="cpu"))
    assert b["img"].shape == (2, S, S, 3) and b["img"].dtype == torch.float32
    assert b["targets"].shape == (2, 8 * 30, 5)       # mixup: two mosaics
    assert 0 <= float(b["img"].min()) and float(b["img"].max()) <= 1
