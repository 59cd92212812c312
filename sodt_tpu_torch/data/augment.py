"""Batched training augmentation on the device: mosaic, perspective, HSV,
flips, mixup (`sodt_tpu/data/augment.py`).

Every function works on a batch (leading axis B) of NHWC tensors on one
device, where JAX writes one sample and `jax.vmap`s it. Geometry is applied
identically to RGB and IR; HSV touches RGB only.

Each random function of the JAX module is split in two:

  draws  made on the host from a numpy `Generator` (`perspective_draws`,
         `mosaic_centers`, `hsv_draws`, `flip_draws`, `mixup_draws`,
         gathered for one step by `augment_draws` into one (B, N_DRAWS)
         float32 array that goes to the device as one small tensor);
  apply  deterministic torch functions of (tiles, draws).

The draw streams differ from `jax.random`'s threefry by design: the same
seed gives the port other draws than the JAX package. The split keeps the
port free of `torch.distributions` (mixup's Beta(32, 32) needs a generator)
and lets the card and the CPU see identical draws.

The perspective matrices are composed and inverted on the host with the
draws, so the card and the CPU warp with the same f32 matrix. Source
coordinates are formed as XLA forms them on the CPU, as fma chains, here in
float64 and rounded once to f32: fma(y, m01, x * m00) + m02 for the gather
warp, fma(a, i, b) for each axis of the separable one. A warp is
continuous in its coordinates, but one f32 step of a coordinate near
1,000 px moves a pixel on a 200-level edge by 0.02, so the coordinates are
made equal rather than close.

The tiles stay uint8 through the mosaic; the warps cast to f32 where they
sample, as in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.boxes import xywhn2xyxy


# ---------------------------------------------------------------- sampling

def _f32(x: torch.Tensor) -> torch.Tensor:
    """Round float64 to f32 and back: one rounding step of an fma chain."""
    return x.float().double()


def _affine_rows(x: torch.Tensor, y: torch.Tensor, m: torch.Tensor):
    """The three rows of [x, y, 1] @ m.T for f32 points and matrices, each
    rounded as XLA's CPU dot rounds it: fma(y, m[r, 1], x * m[r, 0]) +
    m[r, 2]. x, y and m[..., r, k] must broadcast."""
    x, y, m = x.double(), y.double(), m.double()
    return [(_f32(y * m[..., r, 1] + _f32(x * m[..., r, 0]))
             + m[..., r, 2]).float() for r in range(3)]


def affine_sample(img: torch.Tensor, minv: torch.Tensor,
                  out_hw: tuple[int, int],
                  pad_value: float = 114.0) -> torch.Tensor:
    """Bilinear-sample `img` (B, H, W, C) at the output grid mapped by
    `minv` (B, 3, 3), the inverse transform (output px -> input px).
    Samples outside the source take `pad_value`. Returns f32 (B, oh, ow, C).
    """
    oh, ow = out_hw
    b, h, w, c = img.shape
    dev = img.device
    xs = torch.arange(ow, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(oh, dtype=torch.float32, device=dev)[None, :, None]
    mi = minv[:, None, None]                              # (B, 1, 1, 3, 3)
    s0, s1, s2 = _affine_rows(xs, ys, mi)                 # (B, oh, ow)
    sx = s0 / s2
    sy = s1 / s2
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    flat = img.reshape(b, h * w, c)
    bi = torch.arange(b, device=dev)[:, None, None]

    def gather(yq, xq):
        inb = (xq >= 0) & (xq <= w - 1) & (yq >= 0) & (yq <= h - 1)
        xc = xq.clamp(0, w - 1).long()
        yc = yq.clamp(0, h - 1).long()
        vals = flat[bi, yc * w + xc].float()              # (B, oh, ow, C)
        return torch.where(inb[..., None], vals,
                           torch.full_like(vals, pad_value))

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _axis_weights(a: torch.Tensor, b: torch.Tensor, n_in: int, n_out: int):
    """The two taps of a 1-D bilinear resample s = a * i + b, per batch row:
    (i0, i1) long indices clipped into [0, n_in), (w0, w1) f32 weights that
    are zero where the tap falls outside, and cov = w0 + w1, the in-bounds
    weight mass (for the constant-border blend). JAX builds the same taps as
    a dense (n_out, n_in) matrix for the MXU; a row of it holds exactly
    these two weights."""
    dev = a.device
    i = torch.arange(n_out, dtype=torch.float64, device=dev)[None]
    s = (i * a.double()[:, None] + b.double()[:, None]).float()   # fma
    i0 = torch.floor(s)
    f = s - i0

    def tap(idx, wt):
        inb = (idx >= 0) & (idx <= n_in - 1)
        return idx.clamp(0, n_in - 1).long(), wt * inb

    j0, w0 = tap(i0, 1.0 - f)
    j1, w1 = tap(i0 + 1.0, f)
    return j0, j1, w0, w1, w0 + w1


def separable_affine_sample(img: torch.Tensor, minv: torch.Tensor,
                            out_hw: tuple[int, int],
                            pad_value: float = 114.0) -> torch.Tensor:
    """affine_sample for axis-aligned transforms (rotation = shear =
    perspective = 0, the shipped hyps): the warp factorizes into two 1-D
    resamples, rows then columns, each a two-tap blend of gathered lines:
    out = Wy @ img @ Wx^T + pad * (1 - covy x covx). The caller guarantees
    the structure (minv[:, 0, 1] == minv[:, 1, 0] == minv[:, 2, :2] == 0).
    """
    oh, ow = out_hw
    b, h, w, c = img.shape
    y0, y1, wy0, wy1, covy = _axis_weights(minv[:, 1, 1], minv[:, 1, 2], h, oh)
    x0, x1, wx0, wx1, covx = _axis_weights(minv[:, 0, 0], minv[:, 0, 2], w, ow)

    def rows(idx):
        return torch.gather(img, 1, idx[:, :, None, None].expand(b, oh, w, c))

    t1 = (wy0[:, :, None, None] * rows(y0).float()
          + wy1[:, :, None, None] * rows(y1).float())     # (B, oh, w, C)

    def cols(idx):
        return torch.gather(t1, 2, idx[:, None, :, None].expand(b, oh, ow, c))

    out = (wx0[:, None, :, None] * cols(x0)
           + wx1[:, None, :, None] * cols(x1))
    border = 1.0 - covy[:, :, None] * covx[:, None, :]
    return out + pad_value * border[..., None]


# ----------------------------------------------------- random perspective

class PerspectiveParams(NamedTuple):
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0

    @classmethod
    def from_hyp(cls, hyp: dict) -> "PerspectiveParams":
        return cls(degrees=hyp.get("degrees", 0.0),
                   translate=hyp.get("translate", 0.1),
                   scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0),
                   perspective=hyp.get("perspective", 0.0))

    @property
    def axis_aligned(self) -> bool:
        """Every draw is axis-aligned: the warp may run separably."""
        return self.degrees == 0 and self.shear == 0 and self.perspective == 0


def perspective_draws(rng: np.random.Generator, n: int, p: PerspectiveParams,
                      out_hw: tuple[int, int]) -> np.ndarray:
    """The draws of JAX's `_perspective_matrix` for n samples, in its
    ranges: (n, 8) [px, py, a_deg, s, shx_deg, shy_deg, tx, ty]."""
    oh, ow = out_hw
    u = lambda lo, hi: rng.uniform(lo, hi, n)
    cols = [u(-p.perspective, p.perspective), u(-p.perspective, p.perspective),
            u(-p.degrees, p.degrees), u(1 - p.scale, 1 + p.scale),
            u(-p.shear, p.shear), u(-p.shear, p.shear),
            u(0.5 - p.translate, 0.5 + p.translate) * ow,
            u(0.5 - p.translate, 0.5 + p.translate) * oh]
    return np.stack(cols, 1).astype(np.float32)


def compose_perspective_matrix(draws: torch.Tensor,
                               in_hw: tuple[int, int]) -> torch.Tensor:
    """M = T @ Sh @ R @ P @ C (B, 3, 3) f32 from `perspective_draws`, as
    JAX composes it. R follows cv2.getRotationMatrix2D's sign convention:
    [[cos, sin], [-sin, cos]] * s."""
    ih, iw = in_hw
    d = draws.float()
    px, py, a_deg, s, shx_deg, shy_deg, tx, ty = d.unbind(1)
    n = d.shape[0]
    eye = torch.eye(3, dtype=torch.float32, device=d.device).repeat(n, 1, 1)
    C = eye.clone()
    C[:, 0, 2] = -iw / 2
    C[:, 1, 2] = -ih / 2
    P = eye.clone()
    P[:, 2, 0] = px
    P[:, 2, 1] = py
    a = a_deg * math.pi / 180.0
    R = eye.clone()
    R[:, 0, 0] = torch.cos(a) * s
    R[:, 0, 1] = torch.sin(a) * s
    R[:, 1, 0] = -torch.sin(a) * s
    R[:, 1, 1] = torch.cos(a) * s
    Sh = eye.clone()
    Sh[:, 0, 1] = torch.tan(shx_deg * math.pi / 180.0)
    Sh[:, 1, 0] = torch.tan(shy_deg * math.pi / 180.0)
    T = eye.clone()
    T[:, 0, 2] = tx
    T[:, 1, 2] = ty
    return T @ Sh @ R @ P @ C


def box_candidates(box1: torch.Tensor, box2: torch.Tensor, wh_thr=2.0,
                   ar_thr=20.0, area_thr=0.1, eps=1e-16) -> torch.Tensor:
    """Keep boxes that survived the warp. box1 / box2: (..., 4) xyxy before
    / after. Returns bool (...)."""
    w1 = box1[..., 2] - box1[..., 0]
    h1 = box1[..., 3] - box1[..., 1]
    w2 = box2[..., 2] - box2[..., 0]
    h2 = box2[..., 3] - box2[..., 1]
    ar = torch.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def warp_labels(labels_xyxy: torch.Tensor, mask: torch.Tensor,
                m: torch.Tensor, out_hw: tuple[int, int], s: torch.Tensor):
    """Transform padded xyxy pixel labels (B, N, 4) by m (B, 3, 3); clip
    and filter. `s` (B,) is the scale draw of m: the warped areas are held
    against the SCALED originals, so a pure zoom never kills a box."""
    oh, ow = out_hw
    x1, y1, x2, y2 = labels_xyxy.unbind(-1)
    cx = torch.stack([x1, x2, x1, x2], -1)                # (B, N, 4) corners
    cy = torch.stack([y1, y1, y2, y2], -1)
    p0, p1, p2 = _affine_rows(cx, cy, m[:, None, None])
    px, py = p0 / p2, p1 / p2
    new = torch.stack([px.amin(-1).clamp(0, ow), py.amin(-1).clamp(0, oh),
                       px.amax(-1).clamp(0, ow), py.amax(-1).clamp(0, oh)],
                      -1)
    keep = mask & box_candidates(labels_xyxy * s[:, None, None], new)
    return new, keep


# the layout of one sample's warp in the draws: M (9), M^-1 (9), scale draw
WARP = 19


def warp_draws(persp: np.ndarray, in_hw: tuple[int, int]) -> np.ndarray:
    """(n, 8) perspective draws -> (n, WARP) [M, M^-1, s], composed and
    inverted on the host in f32."""
    d = torch.from_numpy(persp)
    m = compose_perspective_matrix(d, in_hw)
    minv = torch.linalg.inv(m)
    return torch.cat([m.reshape(-1, 9), minv.reshape(-1, 9), d[:, 3:4]],
                     1).numpy()


def random_perspective(img, ir, labels_xyxy, mask, warp: torch.Tensor,
                       p: PerspectiveParams, out_hw, pad_value=114.0):
    """Warp a batch (img, ir (B, H, W, C); padded pixel xyxy labels) by its
    `warp` rows (B, WARP) from `warp_draws`. The axis-aligned hyps (a
    static choice, as in JAX) run the separable sampler."""
    m = warp[:, :9].reshape(-1, 3, 3)
    minv = warp[:, 9:18].reshape(-1, 3, 3)
    sample = separable_affine_sample if p.axis_aligned else affine_sample
    img_w = sample(img, minv, out_hw, pad_value)
    ir_w = sample(ir, minv, out_hw, pad_value)
    new_labels, keep = warp_labels(labels_xyxy, mask, m, out_hw, warp[:, 18])
    return img_w, ir_w, new_labels, keep


# --------------------------------------------------------------- mosaic 4

def mosaic_centers(rng: np.random.Generator, n: int, s: int) -> np.ndarray:
    """The jittered mosaic centres (n, 2) [cx, cy], uniform in
    [s/2, 3s/2] and floored."""
    return np.floor(rng.uniform(0.5 * s, 1.5 * s, (n, 2))).astype(np.float32)


def mosaic4(imgs, irs, labels_xyxy, masks, centers, s: int, pad_value=114):
    """4-tile mosaics on 2s x 2s canvases.

    imgs / irs: (B, 4, s, s, C) (uint8 stays uint8); labels_xyxy
    (B, 4, M, 4) pixel coordinates in each tile's frame; masks (B, 4, M);
    centers (B, 2) from `mosaic_centers`. Tile i touches the centre with
    its matching corner (0 top-left of it, 1 top-right, 2 bottom-left, 3
    bottom-right), so the four tiles are the canvas's four quadrants around
    the centre and never overlap. JAX pastes into a 4s x 4s scratch only to
    keep jit shapes static; here each canvas pixel gathers its quadrant's
    tile pixel, or the pad. Returns canvases and labels (B, 4M, 4) clipped
    to [0, 2s], masks (B, 4M)."""
    b = imgs.shape[0]
    dev = imgs.device
    cx = centers[:, 0].long()[:, None]
    cy = centers[:, 1].long()[:, None]
    t = torch.arange(2 * s, device=dev)[None]

    def axis(c):
        hi = t >= c                                       # the far tiles
        src = torch.where(hi, t - c, t - c + s)
        return hi.long(), src.clamp(0, s - 1), (src >= 0) & (src < s)

    ty, sy, vy = axis(cy)                                 # (B, 2s)
    tx, sx, vx = axis(cx)
    idx = (((2 * ty[:, :, None] + tx[:, None, :]) * s + sy[:, :, None]) * s
           + sx[:, None, :])                              # (B, 2s, 2s)
    valid = (vy[:, :, None] & vx[:, None, :])[..., None]
    bi = torch.arange(b, device=dev)[:, None, None]

    def paste(tiles):
        flat = tiles.reshape(b, 4 * s * s, tiles.shape[-1])
        return torch.where(valid, flat[bi, idx],
                           torch.full((), pad_value, dtype=tiles.dtype,
                                      device=dev))

    ox = torch.stack([cx - s, cx, cx - s, cx], 1).float()    # (B, 4, 1)
    oy = torch.stack([cy - s, cy - s, cy, cy], 1).float()
    off = torch.stack([ox, oy, ox, oy], -1)                  # (B, 4, 1, 4)
    labels = (labels_xyxy + off).reshape(b, -1, 4).clamp(0, 2 * s)
    return paste(imgs), paste(irs), labels, masks.reshape(b, -1)


# ------------------------------------------------------------------- HSV

def hsv_draws(rng: np.random.Generator, n: int, h_gain=0.015, s_gain=0.7,
              v_gain=0.4) -> np.ndarray:
    """(n, 3) gains r = uniform(-1, 1) * gain + 1 for (hue, sat, val)."""
    u = rng.uniform(-1.0, 1.0, (n, 3))
    return (u * np.array([h_gain, s_gain, v_gain]) + 1).astype(np.float32)


def hsv_apply(img: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Scale (hue, sat, val) of float RGB (B, H, W, 3) in [0, 255] by gains
    r (B, 3): the float equivalent of the reference's uint8 LUTs
    (x * r0 % 180, clip(x * r1), clip(x * r2)). `%` is floor-mod
    (torch.remainder) and the branch order mx == r, then mx == g decides
    ties, as in JAX."""
    x = img / 255.0
    mx = x.amax(-1)
    mn = x.amin(-1)
    diff = mx - mn + 1e-12
    rch, gch, bch = x.unbind(-1)
    hue = torch.where(
        mx == rch, torch.remainder((gch - bch) / diff, 6.0),
        torch.where(mx == gch, (bch - rch) / diff + 2.0,
                    (rch - gch) / diff + 4.0)) / 6.0
    sat = torch.where(mx > 0, diff / (mx + 1e-12), torch.zeros_like(mx))
    val = mx

    g = r[:, None, None, :]
    hue = torch.remainder(hue * g[..., 0], 1.0)
    sat = (sat * g[..., 1]).clamp(0, 1)
    val = (val * g[..., 2]).clamp(0, 1)

    i = torch.floor(hue * 6.0)
    f = hue * 6.0 - i
    pch = val * (1 - sat)
    q = val * (1 - f * sat)
    t = val * (1 - (1 - f) * sat)
    i = torch.remainder(i.long(), 6)[..., None]
    pick = lambda *c: torch.gather(torch.stack(c, -1), -1, i)[..., 0]
    rgb = torch.stack([pick(val, q, pch, pch, t, val),
                       pick(t, val, val, q, pch, pch),
                       pick(pch, pch, t, val, val, q)], -1)
    return rgb * 255.0


# ----------------------------------------------------------------- flips

def flip_draws(rng: np.random.Generator, n: int, flipud_p=0.0,
               fliplr_p=0.5) -> np.ndarray:
    """(n, 2) [do_ud, do_lr] as 0. / 1."""
    u = rng.uniform(0.0, 1.0, (n, 2))
    return (u < np.array([flipud_p, fliplr_p])).astype(np.float32)


def flips(img, ir, labels_xywhn, mask, do_ud: torch.Tensor,
          do_lr: torch.Tensor):
    """Up/down and left/right flips of both modalities and the labels
    (B, N, 5) [cls, x, y, w, h] normalized: left/right sets column 1,
    up/down column 2. do_ud / do_lr: (B,) bool."""
    ud = do_ud[:, None, None, None]
    lr = do_lr[:, None, None, None]
    img = torch.where(ud, img.flip(1), img)
    ir = torch.where(ud, ir.flip(1), ir)
    img = torch.where(lr, img.flip(2), img)
    ir = torch.where(lr, ir.flip(2), ir)
    y = labels_xywhn.clone()
    y[..., 2] = torch.where(do_ud[:, None], 1.0 - y[..., 2], y[..., 2])
    y[..., 1] = torch.where(do_lr[:, None], 1.0 - y[..., 1], y[..., 1])
    return img, ir, y, mask


def mixup_draws(rng: np.random.Generator, n: int, p: float) -> np.ndarray:
    """(n, 2) [do, lam]: do with probability p, lam ~ Beta(32, 32)."""
    do = rng.uniform(0.0, 1.0, n) < p
    lam = rng.beta(32.0, 32.0, n)
    return np.stack([do, lam], 1).astype(np.float32)


def mixup(img1, ir1, l1, m1, img2, ir2, l2, m2, lam: torch.Tensor):
    """Blend two batches of mosaics with lam (B,); the labels of both are
    kept."""
    w = lam[:, None, None, None]
    img = img1 * w + img2 * (1 - w)
    ir = ir1 * w + ir2 * (1 - w)
    return (img, ir, torch.cat([l1, l2], 1), torch.cat([m1, m2], 1))


# ------------------------------------------------------- one step's draws

# columns of one sample's draws (`augment_draws`): the warps of the primary
# mosaic (a), of mixup's second mosaic (b) and of the single-tile branch (s),
# the two mosaic centres, HSV gains, flips, mixup's [do, lam], the mosaic
# gate
DRAW_COLS = {"warp_a": (0, 19), "warp_b": (19, 38), "warp_s": (38, 57),
             "center_a": (57, 59), "center_b": (59, 61), "hsv": (61, 64),
             "flip": (64, 66), "mix": (66, 68), "mosaic": (68, 69)}
N_DRAWS = 69


def draw_cols(draws: torch.Tensor | np.ndarray, name: str):
    lo, hi = DRAW_COLS[name]
    return draws[:, lo:hi]


def augment_draws(rng: np.random.Generator, n: int, s: int,
                  hyp: dict) -> np.ndarray:
    """Every draw of one step's augmentation for n samples of size s:
    (n, N_DRAWS) float32, made in one fixed order whatever the hyps use."""
    p = PerspectiveParams.from_hyp(hyp)
    out = np.zeros((n, N_DRAWS), np.float32)

    def put(name, v):
        lo, hi = DRAW_COLS[name]
        out[:, lo:hi] = v

    put("warp_a", warp_draws(perspective_draws(rng, n, p, (s, s)),
                             (2 * s, 2 * s)))
    put("center_a", mosaic_centers(rng, n, s))
    put("warp_b", warp_draws(perspective_draws(rng, n, p, (s, s)),
                             (2 * s, 2 * s)))
    put("center_b", mosaic_centers(rng, n, s))
    put("warp_s", warp_draws(perspective_draws(rng, n, p, (s, s)), (s, s)))
    put("hsv", hsv_draws(rng, n, hyp.get("hsv_h", 0.015),
                         hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4)))
    put("flip", flip_draws(rng, n, hyp.get("flipud", 0.0),
                           hyp.get("fliplr", 0.5)))
    put("mix", mixup_draws(rng, n, hyp.get("mixup", 0.0)))
    put("mosaic", rng.uniform(0.0, 1.0, (n, 1)) < hyp.get("mosaic", 1.0))
    return out
