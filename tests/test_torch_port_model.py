"""Whole detector: port plain path vs JAX DetectionModel.apply on raw
Detect maps, after from_jax_variables of a JAX init (perturbed so BN
stats, LN affines, biases and pos_embed all matter), f32 on the CPU."""

import numpy as np
import jax
import pytest
import torch

from sodt_tpu.models import build_model as jbuild
from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.weights import from_jax_variables, save_npz, load_npz

from torch_port_common import rand, t, j, close, NARROW_CFG, randomize_variables

FLAGSHIP = "sodt_tpu/configs/model.yaml"
PORT_FLAGSHIP = "sodt_tpu_torch/configs/model.yaml"


def _compare(jcfg, tcfg, img, batch, seed, tol):
    jm = jbuild(jcfg, ch_in=4, input_mode="RGB+IR")
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, img, img, 3)).astype(np.float32)
    ir = rng.uniform(0, 1, (batch, img, img, 3)).astype(np.float32)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), j(x), j(ir)))
    v = randomize_variables(v, seed)
    ref = jm.apply(v, j(x), j(ir))["raw"]
    tm = tbuild(tcfg, ch_in=4).eval()
    tm.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        out = tm(t(x), t(ir))["raw"]
    assert len(out) == len(ref) == 1
    assert tuple(out[0].shape) == tuple(ref[0].shape)
    close(out[0], ref[0], tol)
    return tm


def test_narrow_model_matches_jax(tmp_path):
    tm = _compare(NARROW_CFG, NARROW_CFG, 128, 2, 0, 1e-4)
    # the .npz round trip val.py --weights-npz reads is exact
    save_npz(tm.state_dict(), tmp_path / "w.npz")
    back = load_npz(tmp_path / "w.npz")
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v), k


def test_flagship_width_model_matches_jax():
    # flagship widths (embed 192) at 128 px: the pos_embed is resampled
    # (antialiased) and stage 3's 8x8 map pads up to one 32x32 window
    _compare(FLAGSHIP, PORT_FLAGSHIP, 128, 1, 1, 1e-4)


def test_compiler_rejects_unported_modules():
    from sodt_tpu_torch.models.compiler import parse_config
    # every name of JAX's registry is ported (ACmix included); a name that
    # JAX does not know raises JAX's KeyError
    acmix = dict(NARROW_CFG,
                 head=[[2, 1, "ACmix", [512]]] + NARROW_CFG["head"][1:])
    assert parse_config(acmix).head[0].name == "ACmix"
    cfg = dict(NARROW_CFG, head=[[2, 1, "Involution", [512]]]
               + NARROW_CFG["head"][1:])
    with pytest.raises(KeyError, match="unknown module 'Involution' in config"):
        parse_config(cfg)
    # a fusion input without steam layers fails in JAX (no stems to run):
    # the port refuses it when the model is built
    from sodt_tpu_torch.models.model import DetectionModel
    spec = parse_config(NARROW_CFG)
    with pytest.raises(ValueError, match="steam"):
        DetectionModel(spec, input_mode="RGB+IR+fusion")
