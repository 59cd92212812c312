"""The feed's switches in the port (`sodt_tpu_torch/data/loader.py`:
`make_train_batches(epochs=, cache=, mosaic=, prefer_native=,
multi_scale_buckets=, scale_seed=, device_bank=)`, `make_bank_feed(
mosaic=, prefer_native=)`) against the JAX package's, on the CPU.

The port's augmentation draws come from its own generator (keyed by
(seed, step)), so batches are held to JAX's with the augmentation off
(every hyp gain 0, `mosaic=False`: the letterbox-only path, the first
tile of each sample as it is): images within 1e-6 and the same targets,
masks and `epoch` fields. With the augmentation on, the two regimes of
each package give the same batches (JAX's tests/test_data.py
test_device_bank_matches_streaming), and the port's `device_bank` switch
gives the batches of the bank gate it overrides.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sodt_tpu.data import loader as jl
from sodt_tpu.data.synthetic import SyntheticVedai as JSynth
from sodt_tpu_torch.data import SyntheticVedai
from sodt_tpu_torch.data import loader as tl

from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = 64
HYP = dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=0.0, translate=0.1,
           scale=0.5, shear=0.0, perspective=0.0, flipud=0.0, fliplr=0.5,
           mosaic=1.0, mixup=0.5)
OFF = dict(HYP, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, translate=0.0, scale=0.0,
           fliplr=0.0, mixup=0.0)          # mosaic stays 1 in the hyp
IMG_TOL = 1e-6


def _take(it, k):
    return [next(it) for _ in range(k)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in ("img", "ir", "targets", "tmask"):
            assert torch.equal(x[k], y[k]), k


def _held_to_jax(port, jax_batches):
    assert len(port) == len(jax_batches)
    for t, j in zip(port, jax_batches):
        assert t["epoch"] == j["epoch"]
        for k in ("img", "ir"):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                       atol=IMG_TOL)
        np.testing.assert_array_equal(t["tmask"].numpy(),
                                      np.asarray(j["tmask"]))
        np.testing.assert_allclose(t["targets"].numpy(),
                                   np.asarray(j["targets"]), atol=IMG_TOL)


@pytest.mark.parametrize("bank", [True, False], ids=["bank", "stream"])
def test_device_bank_switch(bank, monkeypatch, capsys):
    """`device_bank` True / False: the regime's `feed:` line, the batches
    the bank gate gives when patched to the same regime, the other
    regime's batches (augmentation on: mosaic, mixup, HSV, flips), and,
    augmentation off, JAX's `make_train_batches(device_bank=)`."""
    ds = SyntheticVedai(n=8, img_size=S, seed=1)
    kw = dict(seed=3, device="cpu")
    got = _take(tl.make_train_batches(ds, 2, S, HYP, device_bank=bank,
                                      **kw), 5)
    assert ("feed: device bank" if bank else "feed: streaming") in (
        capsys.readouterr().out)
    monkeypatch.setattr(tl, "DEVICE_BANK_MAX_GB",
                        tl.DEVICE_BANK_MAX_GB if bank else 0.0)
    _same(got, _take(tl.make_train_batches(ds, 2, S, HYP, **kw), 5))
    monkeypatch.undo()
    _same(got, _take(tl.make_train_batches(ds, 2, S, HYP,
                                           device_bank=not bank, **kw), 5))
    port = _take(tl.make_train_batches(ds, 2, S, OFF, mosaic=False,
                                       device_bank=bank, **kw), 5)
    jax_b = _take(jl.make_train_batches(JSynth(n=8, img_size=S, seed=1), 2,
                                        S, OFF, mosaic=False,
                                        device_bank=bank,
                                        prefer_native=False, seed=3), 5)
    _held_to_jax(port, jax_b)


@pytest.mark.parametrize("bank", [True, False], ids=["bank", "stream"])
def test_mosaic_false_and_epochs_match_jax(bank):
    """`mosaic=False` takes the letterbox-only path though the hyp's mosaic
    is 1 (the batches of a hyp with mosaic 0, and one tile's labels a
    sample); `epochs=2` stops after two epochs' steps, as JAX's does."""
    ds = SyntheticVedai(n=8, img_size=S, seed=2)
    port = list(tl.make_train_batches(ds, 2, S, OFF, seed=5, mosaic=False,
                                      epochs=2, device_bank=bank,
                                      device="cpu"))
    assert [b["epoch"] for b in port] == [0] * 4 + [1] * 4
    assert port[0]["targets"].shape == (2, 30, 5)
    _same(port, list(tl.make_train_batches(
        ds, 2, S, dict(OFF, mosaic=0.0), seed=5, epochs=2, device_bank=bank,
        device="cpu")))
    mosaic = next(tl.make_train_batches(ds, 2, S, OFF, seed=5,
                                        device_bank=bank, device="cpu"))
    assert mosaic["targets"].shape == (2, 4 * 30, 5)
    jax_b = list(jl.make_train_batches(JSynth(n=8, img_size=S, seed=2), 2,
                                       S, OFF, seed=5, mosaic=False,
                                       epochs=2, device_bank=bank,
                                       prefer_native=False))
    _held_to_jax(port, jax_b)
    feed = tl.make_bank_feed(ds, 2, S, OFF, mosaic=False, device="cpu")
    jfeed = jl.make_bank_feed(JSynth(n=8, img_size=S, seed=2), 2, S, OFF,
                              mosaic=False, prefer_native=False)
    assert feed.mosaic_p == jfeed.mosaic_p == 0.0
    assert feed.use_mixup == jfeed.use_mixup


def test_epochs_with_start_step_stops_at_the_same_step():
    """A feed resumed at step k with `epochs=2` yields the rest of the two
    epochs only."""
    ds = SyntheticVedai(n=8, img_size=S, seed=2)
    kw = dict(seed=5, epochs=2, device="cpu")
    whole = list(tl.make_train_batches(ds, 2, S, HYP, **kw))
    late = list(tl.make_train_batches(ds, 2, S, HYP, start_step=5, **kw))
    assert len(whole) == 8 and len(late) == 3
    _same(late, whole[5:])


def test_prefer_native_false_reads_through_the_dataset(monkeypatch):
    """`prefer_native=False` takes the python dataset even where the
    native loader would load (the bank and streaming feeds both say so),
    with or without the RAM cache (`cache`), and its batches are the
    default feed's."""
    from sodt_tpu_torch.data import native_loader

    class WithFiles(SyntheticVedai):
        img_files = ir_files = ()
    monkeypatch.setattr(native_loader, "available", lambda: True)
    ds = WithFiles(n=4, img_size=S, seed=1)
    for cache in (True, False):
        src = tl._make_tile_source(ds, S, cache, prefer_native=False)
        assert (src.name, src.why) == ("python", "prefer_native=False")
        assert isinstance(src.ds, tl.RamCache) == cache
    feed = tl.make_bank_feed(ds, 2, S, HYP, prefer_native=False,
                             device="cpu")
    assert feed.source.name == "python"
    plain = SyntheticVedai(n=4, img_size=S, seed=1)
    for bank in (True, False):
        kw = dict(seed=1, device_bank=bank, device="cpu")
        _same(_take(tl.make_train_batches(ds, 2, S, HYP, prefer_native=False,
                                          cache=False, **kw), 3),
              _take(tl.make_train_batches(plain, 2, S, HYP, **kw), 3))


@pytest.mark.parametrize("bank", [True, False], ids=["bank", "stream"])
def test_multi_scale_buckets_and_scale_seed_match_jax(bank):
    """`multi_scale_buckets` (0.5, 1) drawn from `scale_seed` 11 (not the
    feed's seed): the sizes of every step and the resized images, as
    JAX's."""
    ds = SyntheticVedai(n=8, img_size=S, seed=2)
    kw = dict(seed=5, mosaic=False, multi_scale=True,
              multi_scale_buckets=(0.5, 1.0), scale_seed=11, epochs=2,
              device_bank=bank)
    port = list(tl.make_train_batches(ds, 2, S, OFF, device="cpu", **kw))
    jax_b = list(jl.make_train_batches(JSynth(n=8, img_size=S, seed=2), 2,
                                       S, OFF, prefer_native=False, **kw))
    sizes = [b["img"].shape[1] for b in port]
    assert sizes == [np.asarray(b["img"]).shape[1] for b in jax_b]
    assert set(sizes) == {32, 64}
    rng = np.random.default_rng(11)
    assert sizes == [(32, 64)[int(rng.integers(2))] for _ in sizes]
    for t, j in zip(port, jax_b):
        np.testing.assert_allclose(t["img"].numpy(), np.asarray(j["img"]),
                                   atol=1e-5)
