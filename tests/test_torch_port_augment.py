"""sodt_tpu_torch.data.augment and loader.augment_batch against
sodt_tpu.data.augment / loader._augment_one on the CPU.

The port takes its draws as a tensor; here they are pulled from the same
jax.random keys that the JAX functions consume, the perspective matrices
included (JAX's own M and inverse, composed and inverted by JAX as its
augmentation does): a warp is continuous in its matrix, but one f32 step
of a source coordinate near 100 px moves a pixel on a 200-level edge by
2e-3, above the bound. `compose_perspective_matrix` is held to JAX's
matrices on its own.

Tolerances: images max |diff| <= 1e-3 on the 0-255 scale, labels <= 1e-3
px, keep masks equal.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sodt_tpu.data import augment as ja
from sodt_tpu.data import loader as jl
from sodt_tpu.data.synthetic import SyntheticVedai as JSynth
from sodt_tpu.ops.boxes import xywhn2xyxy
from sodt_tpu_torch.data import augment as ta
from sodt_tpu_torch.data import loader as tl
from sodt_tpu_torch.data.synthetic import pad_labels

IMG_TOL = 1e-3      # 0-255 scale
LAB_TOL = 1e-3      # px
S = 64
HYP_FILE = dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=0.0,
                translate=0.1, scale=0.5, shear=0.0, perspective=0.0,
                flipud=0.0, fliplr=0.5, mosaic=1.0, mixup=0.0)
HYP_GATHER = dict(HYP_FILE, degrees=10.0, shear=2.0, perspective=0.0005,
                  mixup=0.5, mosaic=0.5)
GATHER = ja.PerspectiveParams(degrees=10, translate=0.1, scale=0.5, shear=2,
                              perspective=0.0005)
AXIS = ja.PerspectiveParams()


def n(x):
    return np.asarray(x)


def held(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(np.asarray(got, np.float64) - n(want)).max())
    assert err <= tol, (what, err)
    return err


def tiles(b, k, seed, s=S):
    """(b, k, s, s, 3) uint8 rgb / ir tiles and (b, k, 30, 5) padded labels
    of the synthetic dataset."""
    ds = JSynth(n=b * k, img_size=s, seed=seed)
    rgb, ir, lab, msk = [], [], [], []
    for i in range(b * k):
        r, q, l = ds[i]
        pl, pm = pad_labels(l, 30)
        rgb.append(r)
        ir.append(q)
        lab.append(pl)
        msk.append(pm)
    sh = lambda x: np.stack(x).reshape((b, k) + x[0].shape)
    return sh(rgb), sh(ir), sh(lab), sh(msk)


def jax_warp(key, in_hw, out_hw, p):
    """JAX's matrix, its inverse and its scale draw as the port's WARP row."""
    m, s = ja._perspective_matrix(key, in_hw, out_hw, p)
    return jnp.concatenate([m.reshape(-1), jnp.linalg.inv(m).reshape(-1),
                            s[None]])


def jax_center(key, s):
    kc, _ = jax.random.split(key)
    cx = jax.random.uniform(kc, (), minval=0.5 * s, maxval=1.5 * s)
    cy = jax.random.uniform(jax.random.fold_in(kc, 1), (), minval=0.5 * s,
                            maxval=1.5 * s)
    return jnp.floor(jnp.stack([cx, cy]))


def jax_draws(key, s, hyp):
    """The port's draws row of one sample, from the keys `_augment_one`
    splits off `key`."""
    k_m, k_p, k_h, k_f, k_x, k_m2, k_p2 = jax.random.split(key, 7)
    p = ja.PerspectiveParams(
        degrees=hyp["degrees"], translate=hyp["translate"], scale=hyp["scale"],
        shear=hyp["shear"], perspective=hyp["perspective"])
    u = lambda k: jax.random.uniform(k)
    pm1 = lambda k: jax.random.uniform(k, (), minval=-1.0, maxval=1.0)
    k1, k2, k3 = jax.random.split(k_h, 3)
    hsv = jnp.stack([pm1(k1) * hyp["hsv_h"] + 1, pm1(k2) * hyp["hsv_s"] + 1,
                     pm1(k3) * hyp["hsv_v"] + 1])
    f1, f2 = jax.random.split(k_f)
    cols = {
        "warp_a": jax_warp(k_p, (2 * s, 2 * s), (s, s), p),
        "warp_b": jax_warp(k_p2, (2 * s, 2 * s), (s, s), p),
        "warp_s": jax_warp(jax.random.fold_in(k_p, 99), (s, s), (s, s), p),
        "center_a": jax_center(k_m, s), "center_b": jax_center(k_m2, s),
        "hsv": hsv,
        "flip": jnp.stack([u(f1) < hyp["flipud"],
                           u(f2) < hyp["fliplr"]]).astype(jnp.float32),
        "mix": jnp.stack([(u(k_x) < hyp["mixup"]).astype(jnp.float32),
                          jax.random.beta(jax.random.fold_in(k_x, 1), 32.0,
                                          32.0)]),
        "mosaic": (u(jax.random.fold_in(k_m, 99))
                   < hyp["mosaic"]).astype(jnp.float32)[None],
    }
    return jnp.concatenate([cols[k] for k in ta.DRAW_COLS])


def keys(seed, b):
    return jax.random.split(jax.random.PRNGKey(seed), b)


@pytest.mark.parametrize("params", [GATHER, AXIS], ids=["gather", "separable"])
def test_warp_samplers_match_jax(params):
    """affine_sample (the gather) and separable_affine_sample on the same
    inverse matrices: uint8 tiles of a 2s canvas into s. JAX runs its
    per-sample functions (jit, no vmap): a vmapped dot of XLA's CPU rounds
    the source coordinates of some samples in another order, which the
    whole-augmentation test below meets."""
    rgb, _, _, _ = tiles(2, 4, 0, S)
    img = rgb.reshape(2, 4 * S, S, 3)[:, :2 * S].reshape(2, 2 * S, S, 3)
    img = np.concatenate([img, img[:, :, ::-1]], 2)          # (2, 2S, 2S, 3)
    ks = keys(3, 2)
    minv = np.stack([n(jnp.linalg.inv(ja._perspective_matrix(
        k, (2 * S, 2 * S), (S, S), params)[0])) for k in ks])

    def ref(fn):
        f = jax.jit(lambda i, m: fn(i, m, (S, S)))
        return np.stack([n(f(jnp.asarray(i), jnp.asarray(m)))
                         for i, m in zip(img, minv)])

    t = torch.from_numpy
    held(ta.affine_sample(t(img), t(minv), (S, S)), ref(ja.affine_sample),
         IMG_TOL, "gather")
    if params == AXIS:
        held(ta.separable_affine_sample(t(img), t(minv), (S, S)),
             ref(ja.separable_affine_sample), IMG_TOL, "separable")


@pytest.mark.parametrize("params", [GATHER, AXIS], ids=["gather", "separable"])
def test_compose_perspective_matrix_matches_jax(params):
    """The matrices from the same draws, and the inverse the host makes."""
    ks = keys(5, 6)
    rows = []
    for k in ks:
        k1, k2, k3, k4, k5, k6, k7 = jax.random.split(k, 7)
        u = lambda k, lo, hi: jax.random.uniform(k, (), minval=lo, maxval=hi)
        k7a, k7b = jax.random.split(k7)
        p = params
        rows.append([u(k1, -p.perspective, p.perspective),
                     u(k2, -p.perspective, p.perspective),
                     u(k3, -p.degrees, p.degrees),
                     u(k4, 1 - p.scale, 1 + p.scale),
                     u(k5, -p.shear, p.shear), u(k6, -p.shear, p.shear),
                     u(k7a, 0.5 - p.translate, 0.5 + p.translate) * S,
                     u(k7b, 0.5 - p.translate, 0.5 + p.translate) * S])
    draws = np.asarray(rows, np.float32)
    ref = np.stack([n(ja._perspective_matrix(k, (2 * S, 2 * S), (S, S),
                                             params)[0]) for k in ks])
    got = ta.compose_perspective_matrix(torch.from_numpy(draws),
                                        (2 * S, 2 * S)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    warp = ta.warp_draws(draws, (2 * S, 2 * S))
    np.testing.assert_allclose(warp[:, 9:18].reshape(-1, 3, 3),
                               np.linalg.inv(ref.astype(np.float64)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(warp[:, 18], draws[:, 3])


@pytest.mark.parametrize("params", [GATHER, AXIS], ids=["gather", "separable"])
def test_random_perspective_matches_jax(params):
    """Images of both modalities, warped labels and keep masks
    (warp_labels, box_candidates)."""
    rgb, ir, lab, msk = tiles(3, 1, 1, 2 * S)
    lab_px = n(xywhn2xyxy(jnp.asarray(lab[:, 0, :, 1:5]), 2 * S, 2 * S))
    ks = keys(7, 3)
    f = jax.jit(jax.vmap(lambda i, q, l, m, k: ja.random_perspective(
        i.astype(jnp.float32), q.astype(jnp.float32), l, m, k, params,
        (S, S))))
    ri, rq, rl, rk = f(rgb[:, 0], ir[:, 0], lab_px, msk[:, 0], ks)
    warp = jax.vmap(lambda k: jax_warp(k, (2 * S, 2 * S), (S, S), params))(ks)
    p = ta.PerspectiveParams(*params)
    gi, gq, gl, gk = ta.random_perspective(
        torch.from_numpy(rgb[:, 0]), torch.from_numpy(ir[:, 0]),
        torch.from_numpy(lab_px), torch.from_numpy(msk[:, 0]),
        torch.from_numpy(n(warp)), p, (S, S))
    held(gi, ri, IMG_TOL, "rgb")
    held(gq, rq, IMG_TOL, "ir")
    held(gl, rl, LAB_TOL, "labels")
    np.testing.assert_array_equal(gk.numpy(), n(rk))
    assert n(rk).any() and not n(rk).all()


def test_mosaic4_matches_jax():
    """Canvases bit-equal in uint8, labels clipped to [0, 2s]."""
    rgb, ir, lab, msk = tiles(4, 4, 2, S)
    lab_px = n(xywhn2xyxy(jnp.asarray(lab[..., 1:5]), S, S))
    ks = keys(11, 4)
    f = jax.jit(jax.vmap(lambda r, q, l, m, k: ja.mosaic4(r, q, l, m, k, S)))
    rc, rq, rl, rm = f(rgb, ir, lab_px, msk, ks)
    centers = torch.from_numpy(n(jax.vmap(lambda k: jax_center(k, S))(ks)))
    gc, gq, gl, gm = ta.mosaic4(torch.from_numpy(rgb), torch.from_numpy(ir),
                                torch.from_numpy(lab_px),
                                torch.from_numpy(msk), centers, S)
    assert gc.dtype == torch.uint8
    np.testing.assert_array_equal(gc.numpy(), n(rc))
    np.testing.assert_array_equal(gq.numpy(), n(rq))
    held(gl, rl, LAB_TOL, "labels")
    np.testing.assert_array_equal(gm.numpy(), n(rm))


def test_hsv_matches_jax():
    """Integer pixels (channel ties, grays, negative hue) and warped
    (fractional) ones, gains from the same keys."""
    rng = np.random.default_rng(4)
    ints = rng.integers(0, 256, (2, 24, 24, 3)).astype(np.float32)
    ints[0, :4] = ints[0, :4, :, :1]                         # grays
    ints[0, 4:8, :, 1] = ints[0, 4:8, :, 0]                  # r == g ties
    frac = rng.uniform(0, 255, (2, 24, 24, 3)).astype(np.float32)
    ks = keys(13, 2)
    for img in (ints, frac):
        ref = jax.jit(jax.vmap(ja.hsv_augment))(jnp.asarray(img), ks)
        k3 = jax.vmap(lambda k: jax.random.split(k, 3))(ks)
        u = jax.vmap(jax.vmap(lambda k: jax.random.uniform(
            k, (), minval=-1.0, maxval=1.0)))(k3)
        r = n(u) * np.array([0.015, 0.7, 0.4], np.float32) + 1
        got = ta.hsv_apply(torch.from_numpy(img), torch.from_numpy(r))
        held(got, ref, IMG_TOL, "hsv")


def test_flips_and_mixup_match_jax():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (8, 16, 16, 3)).astype(np.float32)
    ir = rng.uniform(0, 255, (8, 16, 16, 3)).astype(np.float32)
    lab = rng.uniform(0, 1, (8, 6, 5)).astype(np.float32)
    msk = rng.uniform(0, 1, (8, 6)) < 0.5
    ks = keys(17, 8)
    ri, rq, rl, rm = jax.vmap(lambda a, b, c, d, k: ja.flips(
        a, b, c, d, k, 0.5, 0.5))(img, ir, lab, msk, ks)
    f12 = jax.vmap(lambda k: jnp.stack([jax.random.uniform(kk) for kk in
                                        jax.random.split(k)]))(ks)
    do = n(f12) < 0.5
    assert do[:, 0].any() and do[:, 1].any() and not do.all()
    gi, gq, gl, gm = ta.flips(*map(torch.from_numpy, (img, ir, lab, msk)),
                              torch.from_numpy(do[:, 0]),
                              torch.from_numpy(do[:, 1]))
    held(gi, ri, IMG_TOL, "rgb")
    held(gq, rq, IMG_TOL, "ir")
    held(gl, rl, 1e-6, "labels")
    np.testing.assert_array_equal(gm.numpy(), n(rm))

    half = lambda x: (x[:4], x[4:])
    (a1, a2), (b1, b2), (l1, l2), (m1, m2) = map(half, (img, ir, lab, msk))
    ref = jax.vmap(ja.mixup)(a1, b1, l1, m1, a2, b2, l2, m2, ks[:4])
    lam = n(jax.vmap(lambda k: jax.random.beta(k, 32.0, 32.0))(ks[:4]))
    got = ta.mixup(*map(torch.from_numpy, (a1, b1, l1, m1, a2, b2, l2, m2)),
                   torch.from_numpy(lam))
    for g, r in zip(got, ref):
        held(g.float(), np.asarray(r, np.float32), IMG_TOL, "mixup")


@pytest.mark.parametrize("hyp", [HYP_FILE, HYP_GATHER],
                         ids=["hyp_file", "gather_mixup_mosaic05"])
def test_augment_batch_matches_jax_augment_one(hyp):
    """The whole augmentation of a batch under the same keys: the hyp
    file's settings (separable warp, mosaic always, no mixup), and the
    gather warp with mixup and the mosaic gate at 0.5 (both branches and
    both mixup outcomes present)."""
    b = 8
    rgb, ir, lab, msk = tiles(b, 4, 3)
    rgb2, ir2, lab2, msk2 = tiles(b, 4, 4)
    ks = keys(19, b)
    use_mixup = hyp["mixup"] > 0
    fn = jl.make_augment_fn(S, hyp, use_mixup, hyp["mosaic"])
    args = (rgb, ir, lab, msk) + ((rgb2, ir2, lab2, msk2) if use_mixup else ())
    ri, rq, rt, rm = fn(*args, ks)
    draws = n(jax.jit(jax.vmap(functools.partial(jax_draws, s=S, hyp=hyp)))(ks))
    if hyp["mosaic"] < 1:
        gate = draws[:, ta.DRAW_COLS["mosaic"][0]]
        assert 0 < gate.sum() < b
    if use_mixup:
        mix = draws[:, ta.DRAW_COLS["mix"][0]]
        assert 0 < mix.sum() < b
    t = torch.from_numpy
    sec = (rgb2, ir2, lab2, msk2) if use_mixup else (rgb, ir, lab, msk)
    gi, gq, gt, gm = tl.augment_batch(
        *map(t, (rgb, ir, lab, msk) + sec), t(draws), s=S, hyp=hyp,
        use_mixup=use_mixup, mosaic_p=hyp["mosaic"])
    assert gi.shape == ri.shape and gt.shape == rt.shape
    held(gi * 255, n(ri) * 255, IMG_TOL, "rgb")
    held(gq * 255, n(rq) * 255, IMG_TOL, "ir")
    np.testing.assert_array_equal(gm.numpy(), n(rm))
    np.testing.assert_array_equal(gt[..., 0].numpy(), n(rt)[..., 0])
    held(gt[..., 1:] * S, n(rt)[..., 1:] * S, LAB_TOL, "labels")


def test_augment_draws_are_keyed_by_seed_and_step():
    """One fixed draw order: the same (seed, step) gives the same draws,
    another step others; draws stay in the hyps' ranges."""
    a = tl.step_draws(0, 3, 4, S, HYP_GATHER)
    np.testing.assert_array_equal(a, tl.step_draws(0, 3, 4, S, HYP_GATHER))
    assert not np.array_equal(a, tl.step_draws(0, 4, 4, S, HYP_GATHER))
    assert a.shape == (4, ta.N_DRAWS) and a.dtype == np.float32
    c = ta.draw_cols(a, "center_a")
    assert (c >= S // 2).all() and (c <= 3 * S // 2).all()
    lam = ta.draw_cols(a, "mix")[:, 1]
    assert ((lam > 0.2) & (lam < 0.8)).all()
    m = ta.draw_cols(a, "warp_a")
    inv = m[:, 9:18].reshape(-1, 3, 3) @ m[:, :9].reshape(-1, 3, 3)
    np.testing.assert_allclose(inv, np.broadcast_to(np.eye(3), inv.shape),
                               atol=1e-4)
