"""Test-time augmentation of the port (`sodt_tpu_torch/train/tta.py`) against
the JAX package's (`sodt_tpu/train/tta.py`), f32 on the CPU.

Tolerances: `scale_img_shape` equal; `scale_img` <= 1e-6 absolute on
[0, 1] images (the source coordinates are JAX's f32 ops, the taps' sums
may round in another order); `tta_forward` <= 1e-4 (relative and
absolute, as `torch_port_common.close`) on the decoded predictions of
three passes; the TTA eval step's survivors equal and their boxes,
scores and classes <= 1e-4. Every image is asymmetric (random, non-square
or with a ramp along x), so a flip on the wrong axis or a missing de-flip
shows.
"""

import numpy as np
import jax
import pytest
import torch

from sodt_tpu.train import tta as jtta
from sodt_tpu.train.evaluate import make_eval_step as jstep
from sodt_tpu_torch.train import tta as ttta
from sodt_tpu_torch.train.evaluate import make_eval_step as tstep
from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches

from torch_port_common import (close, j, narrow_pair, same_dets, t,
                               tiny_pair, trained_pair)

RESIZE_TOL = 1e-6
TTA_TOL = 1e-4


@pytest.mark.parametrize("h,w,ratio,gs", [
    (512, 512, 0.83, 32), (512, 512, 0.67, 32), (640, 480, 0.83, 32),
    (97, 131, 0.67, 4), (300, 200, 1.0, 32), (384, 1024, 0.67, 64)])
def test_torch_scale_img_shape_equals_jax(h, w, ratio, gs):
    assert ttta.scale_img_shape(h, w, ratio, gs) == jtta.scale_img_shape(
        h, w, ratio, gs)


@pytest.mark.parametrize("shape,ratio", [
    ((2, 64, 96, 3), 0.83), ((2, 64, 96, 3), 0.67), ((1, 75, 53, 4), 0.83),
    ((1, 128, 128, 3), 0.67), ((1, 40, 40, 3), 1.0)])
def test_torch_scale_img_matches_jax(shape, ratio):
    x = np.random.default_rng(3).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jtta.scale_img(j(x), ratio, 32))
    got = ttta.scale_img(t(x), ratio, 32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)
    if ratio != 1.0:
        nh, nw, ph, pw = ttta.scale_img_shape(*shape[1:3], ratio, 32)
        assert (got[:, nh:] == np.float32(0.447)).all()
        assert (got[:, :, nw:] == np.float32(0.447)).all()


def _asymmetric(b, h, w, seed):
    """Random pixels plus a ramp along x: no image is its own mirror."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 0.5, w, dtype=np.float32)[None, None, :, None]
    return (0.5 * rng.uniform(0, 1, (b, h, w, 3)) + ramp).astype(np.float32)


def test_torch_tta_forward_matches_jax():
    """The three passes' decoded predictions, de-scaled and de-flipped, of
    the narrow flagship (RGB+IR, Swin encoder, stride 4 Detect) on a batch
    of two 64 x 96 images (each pass resized, then padded back to 64 x 96).
    The all-CNN tests/tiny.yaml of tests/test_aux.py is held below."""
    jm, v, tm = narrow_pair(0)
    x, ir = _asymmetric(2, 64, 96, 1), _asymmetric(2, 64, 96, 2)
    want = jax.jit(lambda v, x, ir: jtta.tta_forward(jm, v, x, ir))(
        v, j(x), j(ir))
    with torch.no_grad():
        got = ttta.tta_forward(tm, t(x), t(ir))
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want, TTA_TOL)


@pytest.mark.parametrize("h,w", [(64, 64), (64, 96)])
def test_torch_tta_forward_on_tiny_yaml_matches_jax(h, w):
    """tests/test_aux.py's case on the all-CNN tests/tiny.yaml (RGB, one
    Detect level at stride 4), `tta_forward(gs=4)`, with weights drawn and
    carried across by `from_jax_variables`: the three passes' decoded
    predictions, de-scaled and de-flipped, within TTA_TOL."""
    jm, v, tm = tiny_pair(4)
    x = _asymmetric(1, h, w, 7)
    want = jax.jit(lambda v, x: jtta.tta_forward(jm, v, x, x, gs=4))(
        v, j(x))
    with torch.no_grad():
        got = ttta.tta_forward(tm, t(x), t(x), gs=4)
    assert tuple(got.shape) == tuple(want.shape)
    assert want.shape[0] == 1 and want.shape[2] == 8
    assert float(np.asarray(want).std()) > 100 * TTA_TOL
    close(got, want, TTA_TOL)


def test_torch_tta_eval_step_matches_jax():
    """`make_eval_step(augment=True)` on the trained flagship at 256 px
    (three passes at 256, 224 and 192 px), conf 0.1: the same survivors,
    boxes / scores / classes <= 1e-4."""
    jm, v, tm = trained_pair()
    b = next(make_eval_batches(SyntheticVedai(n=2, img_size=256, seed=1),
                               2, 256))
    jd, jv, _ = jstep(jm, augment=True, conf_thres=0.1)(v, b["img"],
                                                         b["ir"])
    td, tv, losses = tstep(tm, augment=True, conf_thres=0.1)(
        torch.from_numpy(b["img"]), torch.from_numpy(b["ir"]))
    assert losses is None
    same_dets(td, tv, jd, jv, TTA_TOL)
