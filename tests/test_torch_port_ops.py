"""Port vs JAX package: pure ops (GELU, boxes, LayerNorm), the antialiased
pos-embed resize, NMS and the eval metrics. f32 on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sodt_tpu.ops import activations as jact, boxes as jbox
from sodt_tpu.ops.nms import batched_nms as jnms
from sodt_tpu.pallas.layernorm import _reference_ln, add_layernorm
from sodt_tpu.utils import metrics as jmet
from sodt_tpu_torch.ops import activations as tact, boxes as tbox
from sodt_tpu_torch.ops.nms import batched_nms as tnms
from sodt_tpu_torch.models.norm import layer_norm, AddLayerNorm
from sodt_tpu_torch.models.backbone import resize_bilinear_nhwc
from sodt_tpu_torch.utils import metrics as tmet

from torch_port_common import rand, t, j, close


def test_gelu_f32_exact_and_bf16_tanh():
    x = rand((4096,), 0, 3.0)
    close(tact.gelu(t(x)), jact.gelu(j(x)), 1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = np.asarray(jact.gelu(j(x).astype(jnp.bfloat16)).astype(jnp.float32))
    # bf16 rounds at other places in the two frameworks: within 2 bf16 ulps
    np.testing.assert_allclose(tact.gelu(xb).float().numpy(), ref,
                               rtol=2 ** -7, atol=2 ** -7)


def test_box_helpers_match():
    b = np.abs(rand((64, 4), 1, 50.0)) + 1.0
    close(tbox.xywh2xyxy(t(b)), jbox.xywh2xyxy(j(b)), 1e-6)
    close(tbox.xywhn2xyxy(t(b / 100), 512, 384),
          jbox.xywhn2xyxy(j(b / 100), 512, 384), 1e-6)
    xy = np.asarray(jbox.xywh2xyxy(j(b)))
    extra = np.concatenate([xy, rand((64, 2), 2)], axis=1)
    close(tbox.clip_coords(t(extra), (40, 60)),
          jbox.clip_coords(j(extra), (40, 60)), 1e-6)
    close(tbox.box_iou(t(xy), t(xy[:17])), jbox.box_iou(j(xy), j(xy[:17])), 1e-6)


@pytest.mark.parametrize("c", [32, 384])
def test_layernorm_and_add_layernorm_match(c):
    x, y = rand((3, 5, 7, c), 3, 2.0) + 0.5, rand((3, 5, 7, c), 4)
    s, b = 1.0 + rand((c,), 5, 0.2), rand((c,), 6, 0.2)
    close(layer_norm(t(x), t(s), t(b)), _reference_ln(j(x), j(s), j(b), 1e-5),
          1e-6)
    ln = AddLayerNorm(c)
    with torch.no_grad():
        ln.weight.copy_(t(s))
        ln.bias.copy_(t(b))
    ts, ty = ln(t(x), t(y))
    js, jy = add_layernorm(j(x), j(y), j(s), j(b))
    close(ts, js, 1e-6)
    close(ty, jy, 1e-6)


@pytest.mark.parametrize("size", [(128, 32), (32, 48), (40, 40)])
def test_pos_embed_resize_matches_jax_antialiased(size):
    src, dst = size
    pos = rand((1, src, src, 8), 7)
    ref = jax.image.resize(j(pos), (1, dst, dst, 8), method="bilinear")
    close(resize_bilinear_nhwc(t(pos), dst, dst), ref, 1e-5)


def _preds(seed, b=2, n=400, nc=3, ties=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(20, 200, (b, n, 2))
    wh = rng.uniform(5, 40, (b, n, 2))
    obj = rng.uniform(0, 1, (b, n, 1))
    cls = rng.uniform(0, 1, (b, n, nc))
    if ties:
        # quantized scores: many exact ties that top-k must break by index
        obj = np.round(obj * 4) / 4
        cls = np.round(cls * 4) / 4
        xy = np.round(xy / 20) * 20
    return np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(conf_thres=0.001, iou_thres=0.6, multi_label=True, merge=True,
         top_k=512, max_det=100),
    dict(conf_thres=0.25, iou_thres=0.45, multi_label=False, merge=False,
         top_k=512, max_det=50),
    dict(conf_thres=0.1, iou_thres=0.5, multi_label=True, merge=True,
         top_k=4096, max_det=300),
])
@pytest.mark.parametrize("ties", [False, True])
def test_batched_nms_equal(kw, ties):
    p = _preds(11, ties=ties)
    jd, jv = jnms(j(p), **kw)
    td, tv = tnms(t(p), **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # selection, scores and classes bit-exact; merged boxes come out of a
    # (max_det, K) @ (K, 4) product whose f32 summation order differs
    # between the two CPU backends: a few ulps
    np.testing.assert_array_equal(td.numpy()[..., 4:], np.asarray(jd)[..., 4:])
    np.testing.assert_allclose(td.numpy()[..., :4], np.asarray(jd)[..., :4],
                               rtol=1e-6, atol=1e-4)


def test_ap_per_class_and_matching_equal():
    rng = np.random.default_rng(5)
    det = np.concatenate([rng.uniform(0, 80, (60, 2)),
                          rng.uniform(90, 160, (60, 2)),
                          np.round(rng.uniform(0, 1, (60, 1)), 2),   # ties
                          rng.integers(0, 3, (60, 1))], 1).astype(np.float32)
    labels = np.concatenate([rng.integers(0, 3, (25, 1)),
                             rng.uniform(0, 80, (25, 2)),
                             rng.uniform(90, 160, (25, 2))], 1).astype(np.float32)
    iouv = np.linspace(0.5, 0.95, 10)
    ct = tmet.match_predictions(det, labels, iouv)
    cj = jmet.match_predictions(det, labels, iouv)
    np.testing.assert_array_equal(ct, cj)
    rt = tmet.ap_per_class(ct, det[:, 4], det[:, 5], labels[:, 0])
    rj = jmet.ap_per_class(cj, det[:, 4], det[:, 5], labels[:, 0])
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a, b)
