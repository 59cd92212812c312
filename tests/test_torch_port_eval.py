"""Port evaluate vs JAX evaluate with the in-repo checkpoint on
SyntheticVedai(n=4, seed=1): mAP@0.5 and mAP within 5e-3. At 128 px the
512-px-trained checkpoint finds no object in either package (both 0); at
256 px it scores mAP@0.5 ~0.77, which makes the comparison bite."""

from pathlib import Path

import numpy as np
import jax
import pytest

from sodt_tpu.models import build_model as jbuild
from sodt_tpu.train.checkpoint import load_checkpoint, eval_variables
from sodt_tpu.train.evaluate import evaluate as jevaluate
from sodt_tpu.data.synthetic import SyntheticVedai as JSynth
from sodt_tpu.data.loader import make_eval_batches as jbatches
from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.weights import from_jax_variables
from sodt_tpu_torch.train.evaluate import evaluate as tevaluate
from sodt_tpu_torch.data import SyntheticVedai as TSynth, make_eval_batches

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("img", [128, 256])
def test_evaluate_matches_jax_on_checkpoint(img):
    v = jax.tree.map(np.asarray, eval_variables(
        load_checkpoint(ROOT / "runs/flagship_r5_150ep/best_stripped")))
    jm = jbuild(str(ROOT / "sodt_tpu/configs/model.yaml"), ch_in=4,
                input_mode="RGB+IR")
    tm = tbuild(str(ROOT / "sodt_tpu_torch/configs/model.yaml"), ch_in=4).eval()
    tm.load_state_dict(from_jax_variables(v))
    mj = jevaluate(jm, v, jbatches(JSynth(n=4, img_size=img, seed=1), 2, img),
                   nc=8, img_size=img)
    mt = tevaluate(tm, make_eval_batches(TSynth(n=4, img_size=img, seed=1), 2, img),
                   nc=8, img_size=img, device="cpu")
    assert mt["seen"] == mj["seen"] == 4
    assert mt["nt"] == mj["nt"]
    for k in ("map50", "map"):
        assert abs(mt[k] - mj[k]) <= 5e-3, (k, mt[k], mj[k])
    if img == 256:
        assert mj["map50"] > 0.5
