"""--rect of the port against the JAX package on the CPU: the letterbox
(sodt_tpu_torch.ops.letterbox: geometry, PIL's BILINEAR in uint8, the
device resize), the rect training schedule (groups, shapes and order) and
the rect augmentation (`rect_augment_batch` against JAX's
`_rect_augment_one`, with the draws pulled from the jax.random keys JAX
consumes; JAX is called per sample and op by op).

Tolerances: images max |diff| <= 1e-3 on the 0-255 scale, labels <= 1e-3
px, keep masks equal; the uint8 letterbox bit-equal."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sodt_tpu.data import augment as ja
from sodt_tpu.data import loader as jl
from sodt_tpu.data.synthetic import SyntheticVedai as JSynth
from sodt_tpu.ops import letterbox as jlb
from sodt_tpu_torch.data import loader as tl
from sodt_tpu_torch.data.synthetic import pad_labels
from sodt_tpu_torch.ops import letterbox as tlb

IMG_TOL = 1e-3      # 0-255 scale
LAB_TOL = 1e-3      # px
HYP_FILE = dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=0.0,
                translate=0.1, scale=0.5, shear=0.0, perspective=0.0,
                flipud=0.0, fliplr=0.5, mosaic=1.0, mixup=0.0)
HYP_GATHER = dict(HYP_FILE, degrees=10.0, shear=2.0, perspective=0.0005,
                  flipud=0.5)

LETTERBOX = [((96, 128), (160, 160), True), ((128, 96), (64, 96), True),
             ((300, 200), (128, 160), True), ((100, 133), (544, 544), False),
             ((37, 53), (64, 64), True), ((512, 512), (544, 544), False),
             ((77, 120), (45, 60), True)]


@pytest.mark.parametrize("shape,new,scaleup", LETTERBOX,
                         ids=[f"{s[0]}x{s[1]}to{n[0]}x{n[1]}"
                              for s, n, _ in LETTERBOX])
def test_letterbox_matches_jax(shape, new, scaleup):
    """letterbox_params equal; letterbox_image_np bit-equal (PIL's
    BILINEAR, up and down, non-square); letterbox_image within 1e-3."""
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    assert tlb.letterbox_params(shape, new, scaleup=scaleup) == \
        jlb.letterbox_params(shape, new, scaleup=scaleup)
    np.testing.assert_array_equal(
        tlb.letterbox_image_np(img, new, scaleup=scaleup),
        jlb.letterbox_image_np(img, new, scaleup=scaleup))
    dev = tlb.letterbox_image(torch.from_numpy(img), new, scaleup=scaleup)
    ref = jlb.letterbox_image(jnp.asarray(img, jnp.float32), new,
                              scaleup=scaleup)
    assert float(np.abs(dev.numpy() - np.asarray(ref)).max()) <= IMG_TOL


class _Shapes:
    """Images of chosen shapes (crops of a synthetic scene) that log every
    item read, so the order of a feed's reads is its schedule."""

    def __init__(self, shapes, seed=0):
        self.shapes = shapes
        base = JSynth(n=len(shapes), img_size=64, seed=seed)
        self.items = [base[i] for i in range(len(shapes))]
        self.labels = [it[2] for it in self.items]
        self.log = []

    def __len__(self):
        return len(self.shapes)

    def __getitem__(self, i):
        self.log.append(i)
        h, w = self.shapes[i]
        rgb, ir, lab = self.items[i]
        return rgb[:h, :w], ir[:h, :w], lab.copy()


# 11 images: four landscape (h / w < 1), two portrait, five square
SHAPES = [(64, 64), (48, 64), (64, 48), (64, 64), (32, 64), (48, 64),
          (64, 64), (64, 40), (64, 64), (40, 64), (64, 64)]


def test_rect_schedule_matches_jax(monkeypatch):
    """Over two epochs: the groups read in JAX's order, member by member
    (the port's RAM cache bypassed, so that every read reaches the
    dataset), and each batch's shape (a non-square group at both ends of
    the aspect sort; the tail group cycled). With the cache each item is
    decoded once."""
    bs, s, n_batches = 3, 128, 8       # the 64 px crops enlarged by PIL
    jds, tds, cached = _Shapes(SHAPES), _Shapes(SHAPES), _Shapes(SHAPES)
    jit = jl.make_rect_train_batches(jds, bs, s, HYP_FILE, seed=4)
    cit = tl.make_rect_train_batches(cached, bs, s, HYP_FILE, seed=4,
                                     device="cpu")
    monkeypatch.setattr(tl, "RamCache", lambda ds: ds)
    tit = tl.make_rect_train_batches(tds, bs, s, HYP_FILE, seed=4,
                                     device="cpu")
    jshapes = [tuple(next(jit)["net_shape"]) for _ in range(n_batches)]
    tb = [next(tit) for _ in range(n_batches)]
    assert [tuple(b["net_shape"]) for b in tb] == jshapes
    assert tds.log == jds.log
    for _ in range(n_batches):
        next(cit)
    n = len(SHAPES)
    assert sorted(cached.log[n:]) == list(range(n))     # after the scan
    assert len(set(jshapes)) >= 3
    assert [b["epoch"] for b in tb] == [0] * 4 + [1] * 4
    for b, hw in zip(tb, jshapes):
        assert b["img"].shape == (bs,) + hw + (3,)
        assert torch.isfinite(b["img"]).all()


def _jax_rect_draws(key, hw, hyp):
    """The port's rect draws of one sample from the keys
    `_rect_augment_one` splits off `key` (under jit, as JAX makes them:
    an eager matrix differs from the jitted one in its last bits)."""
    k_p, k_h, k_f = jax.random.split(key, 3)
    p = ja.PerspectiveParams(
        degrees=hyp["degrees"], translate=hyp["translate"],
        scale=hyp["scale"], shear=hyp["shear"],
        perspective=hyp["perspective"])
    m, sc = ja._perspective_matrix(k_p, hw, hw, p)
    pm1 = lambda k: jax.random.uniform(k, (), minval=-1.0, maxval=1.0)
    k1, k2, k3 = jax.random.split(k_h, 3)
    f1, f2 = jax.random.split(k_f)
    return jnp.concatenate([
        m.reshape(-1), jnp.linalg.inv(m).reshape(-1), sc[None],
        jnp.stack([pm1(k1) * hyp["hsv_h"] + 1, pm1(k2) * hyp["hsv_s"] + 1,
                   pm1(k3) * hyp["hsv_v"] + 1]),
        jnp.stack([jax.random.uniform(f1) < hyp["flipud"],
                   jax.random.uniform(f2) < hyp["fliplr"]]).astype(
                       jnp.float32)])


@pytest.mark.parametrize("hyp", [HYP_FILE, HYP_GATHER],
                         ids=["separable", "gather"])
@pytest.mark.parametrize("hw", [(48, 64), (64, 40)], ids=["wide", "tall"])
def test_rect_augment_matches_jax(hyp, hw):
    bh, bw = hw
    b = 3
    ds = JSynth(n=b, img_size=64, seed=7)
    items = [ds[i] for i in range(b)]
    img = np.stack([it[0][:bh, :bw] for it in items])
    ir = np.stack([it[1][:bh, :bw] for it in items])
    padded = [pad_labels(it[2], 30) for it in items]
    lab = np.stack([p[0] for p in padded])
    msk = np.stack([p[1] for p in padded])
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(2), 5), b)
    # JAX op by op: under jit XLA fuses the warp into HSV and moves a pixel
    # whose channels tie across the hue branch (33 levels on one pixel of
    # the gather case, JAX's jitted run against its own op-by-op run)
    with jax.disable_jit():
        ref = [jl._rect_augment_one(
            jnp.asarray(img[i], jnp.float32), jnp.asarray(ir[i], jnp.float32),
            jnp.asarray(lab[i]), jnp.asarray(msk[i]), keys[i], hw=hw,
            hyp=hyp) for i in range(b)]
    draws = np.array(jax.jit(jax.vmap(
        lambda k: _jax_rect_draws(k, hw, hyp)))(keys))
    t = torch.from_numpy
    got = tl.rect_augment_batch(t(img), t(ir), t(lab), t(msk), t(draws),
                                hw=hw, hyp=hyp)
    for k in (0, 1):
        want = np.stack([np.asarray(r[k]) for r in ref])
        assert float(np.abs(got[k].numpy() - want).max()) * 255 <= IMG_TOL
    want = np.stack([np.asarray(r[2]) for r in ref])
    px = np.array([1, bw, bh, bw, bh], np.float32)
    assert float(np.abs((got[2].numpy() - want)[..., 1:] * px[1:]).max()) \
        <= LAB_TOL
    np.testing.assert_array_equal(got[2].numpy()[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[3].numpy(),
                                  np.stack([np.asarray(r[3]) for r in ref]))
    assert got[3].any()


def test_rect_draws_follow_the_ports_keying():
    """(seed, epoch * groups + group) keys a batch's draws: the same key
    gives the same draws, another key others."""
    a = tl.rect_draws(3, 7, 4, (64, 48), HYP_FILE)
    assert a.shape == (4, 24)          # warp 19, HSV 3, flips 2
    np.testing.assert_array_equal(a, tl.rect_draws(3, 7, 4, (64, 48),
                                                   HYP_FILE))
    assert not np.array_equal(a, tl.rect_draws(3, 8, 4, (64, 48), HYP_FILE))
