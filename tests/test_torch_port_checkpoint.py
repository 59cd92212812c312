"""The in-repo trained checkpoint (runs/flagship_r5_150ep/best_stripped),
read through JAX and carried across with from_jax_variables: raw Detect
maps of the port's plain path vs JAX at 128 px (antialiased pos-embed
resize, stage 3 padded to one 32x32 window), f32 on the CPU."""

from pathlib import Path

import numpy as np
import jax
import torch

from sodt_tpu.models import build_model as jbuild
from sodt_tpu.train.checkpoint import load_checkpoint, eval_variables
from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.weights import from_jax_variables

from torch_port_common import t, j, close

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs/flagship_r5_150ep/best_stripped"


def test_checkpoint_raw_maps_match_jax():
    v = jax.tree.map(np.asarray, eval_variables(load_checkpoint(CKPT)))
    jm = jbuild(str(ROOT / "sodt_tpu/configs/model.yaml"), ch_in=4,
                input_mode="RGB+IR")
    tm = tbuild(str(ROOT / "sodt_tpu_torch/configs/model.yaml"), ch_in=4).eval()
    tm.load_state_dict(from_jax_variables(v))
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    ir = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    ref = jm.apply(v, j(x), j(ir))["raw"][0]
    with torch.no_grad():
        out = tm(t(x), t(ir))["raw"][0]
    close(out, ref, 1e-3)
