"""The eval protocol's extras in the port (`sodt_tpu_torch/train/evaluate.py`,
`val.py`, `utils/metrics.py`, `utils/xlsx.py`, `ops/boxes.py`) against the
JAX package's, f32 on the CPU.

Tolerances: NMS ensembles and hybrid labels in `make_eval_step`: the same
survivors, boxes / scores / classes <= 1e-4 (relative and absolute); the
val loss <= 1e-4 relative; `ConfusionMatrix`, `write_per_class_csv`, the
xlsx workbook's parts, `xyxy2xywh` and `fitness` (with the trainer's
`fitness_from_metrics`): equal; the exports of `evaluate` (`save_json`, `save_txt` + `save_conf`) on
square and rect batches: the same records and lines, each number within
1e-5 relative plus one unit of its written precision (json bbox 1e-3 px,
score 1e-5; txt coordinates 1e-6, conf 1e-5), since one rounding step of
the writer is larger than the packages' f32 gap; `--task study` mAP
within 5e-3 at each size (the bound of `test_torch_port_eval.py`).
"""

import importlib.util
import json
import re
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sodt_tpu.data.loader import make_eval_batches as jbatches
from sodt_tpu.data.vedai import VedaiDataset as JDS
from sodt_tpu.ops import boxes as jboxes
from sodt_tpu.train.evaluate import evaluate as jevaluate
from sodt_tpu.train.evaluate import make_eval_step as jstep
from sodt_tpu.train.loss import LossConfig as JLossConfig
from sodt_tpu.utils import metrics as jmetrics
from sodt_tpu.utils import xlsx as jxlsx
from sodt_tpu_torch import val
from sodt_tpu_torch.data import SyntheticVedai, VedaiDataset as TDS
from sodt_tpu_torch.data import make_eval_batches
from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.ops import boxes as tboxes
from sodt_tpu_torch.train.evaluate import cache_rel_bias
from sodt_tpu_torch.train.evaluate import evaluate as tevaluate
from sodt_tpu_torch.train.evaluate import make_eval_step as tstep
from sodt_tpu_torch.train.loss import LossConfig as TLossConfig
from sodt_tpu_torch.utils import metrics as tmetrics
from sodt_tpu_torch.utils import xlsx as txlsx
from sodt_tpu_torch.weights import from_jax_variables

from torch_port_common import (NARROW_CFG, randomize_variables, same_dets,
                               trained_pair, write_vedai_folder)

ROOT = Path(__file__).resolve().parent.parent
IMG = 256
DET_TOL = 1e-4
LOSS_TOL = 1e-4
EXPORT_REL = 1e-5
MAP_TOL = 5e-3
CONF = 0.1      # the step tests' threshold: survivors far from the gate


@pytest.fixture(scope="module")
def trained():
    return trained_pair()


@pytest.fixture(scope="module")
def batch():
    return next(make_eval_batches(SyntheticVedai(n=2, img_size=IMG, seed=1),
                                  2, IMG))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_vedai_folder(tmp_path_factory.mktemp("folder"))


def _load(module_name: str, path: Path):
    """A repo-root script of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_ensemble_eval_step_matches_jax(trained, batch):
    """An NMS ensemble of the trained flagship and a perturbed copy (BN
    statistics, biases and LN scales moved by `randomize_variables`): the
    two members' decoded predictions concatenated before one NMS."""
    jm, v, tm = trained
    v2 = randomize_variables(v, 7)
    tm2 = tbuild(str(ROOT / "sodt_tpu_torch/configs/model.yaml"), ch_in=4)
    tm2.load_state_dict(from_jax_variables(v2))
    cache_rel_bias(tm2.eval())
    jd, jv, jl = jstep(jm, conf_thres=CONF)([v, v2], batch["img"],
                                            batch["ir"])
    td, tv, tl = tstep([tm, tm2], conf_thres=CONF)(
        torch.from_numpy(batch["img"]), torch.from_numpy(batch["ir"]))
    assert jl is None and tl is None
    same_dets(td, tv, jd, jv, DET_TOL)
    # the ensemble is not the first member alone
    d1, v1, _ = tstep(tm, conf_thres=CONF)(torch.from_numpy(batch["img"]),
                                           torch.from_numpy(batch["ir"]))
    assert not (torch.equal(v1, tv) and torch.equal(d1, td))


def test_torch_hybrid_eval_step_and_val_loss_match_jax(trained, folder):
    """`hybrid_labels`: the ground truth as unit-confidence candidates at
    the batch's (W, H), masked slots at obj 0, on a non-square batch (the
    folder's portrait pair, rect-batched at 288 x 224, so a swapped W / H
    shows); with `loss_cfg` the val loss of the single model."""
    jm, v, tm = trained
    *_, batch = make_eval_batches(TDS(str(folder["eval_list"]),
                                      img_size=IMG), 2, IMG, rect=True)
    assert batch["img"].shape[1:3] == (288, 224)
    hyp = dict(hyp_box=0.05, hyp_obj=1.0, hyp_cls=0.5)
    jcfg = JLossConfig(nc=8, anchors=jm.spec.anchors,
                       strides=jm.spec.detect_strides, **hyp)
    tcfg = TLossConfig(nc=8, anchors=tm.spec.anchors,
                       strides=tm.spec.detect_strides, **hyp)
    args = [batch[k] for k in ("img", "ir", "targets", "tmask")]
    jd, jv, jl = jstep(jm, conf_thres=CONF, hybrid_labels=True,
                       loss_cfg=jcfg)(v, *args)
    td, tv, tl = tstep(tm, conf_thres=CONF, hybrid_labels=True,
                       loss_cfg=tcfg)(*map(torch.from_numpy, args))
    same_dets(td, tv, jd, jv, DET_TOL)
    assert set(tl) == set(jl) == {"box", "obj", "cls"}
    for k in tl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]),
                                   rtol=LOSS_TOL, atol=0)


def test_torch_confusion_matrix_equals_jax():
    rng = np.random.default_rng(0)
    for trial in range(20):
        n, m = rng.integers(0, 12), rng.integers(1, 8)
        xy = rng.uniform(0, 200, (n, 2))
        det = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2)),
                              rng.uniform(0, 1, (n, 1)),
                              rng.integers(0, 4, (n, 1))], 1)
        gxy = rng.uniform(0, 200, (m, 2))
        if n:   # some labels on top of detections
            gxy[: min(m, n)] = xy[: min(m, n)] + rng.normal(0, 3, (
                min(m, n), 2))
        lab = np.concatenate([rng.integers(0, 4, (m, 1)), gxy,
                              gxy + rng.uniform(5, 40, (m, 2))], 1)
        jc, tc = jmetrics.ConfusionMatrix(nc=4), tmetrics.ConfusionMatrix(nc=4)
        jc.process_batch(det, lab)
        tc.process_batch(det, lab)
        np.testing.assert_array_equal(tc.matrix, jc.matrix)
    assert tmetrics.fitness(np.array([[0.1, 0.2, 0.9, 0.5]])) == \
        jmetrics.fitness(np.array([[0.1, 0.2, 0.9, 0.5]]))


def _metrics():
    return {"seen": 16, "nt": [5, 0, 7, 1], "mp": 0.912345678,
            "mr": 0.5, "map50": 0.75, "map": 0.4321,
            "per_class": {0: dict(p=0.9, r=0.8, ap50=0.7, ap=0.6),
                          2: dict(p=1.0, r=0.25, ap50=0.123456789,
                                  ap=1e-7),
                          3: dict(p=0.0, r=0.0, ap50=0.0, ap=0.0)}}


def test_torch_per_class_csv_equals_jax_bytes(tmp_path):
    names = ["car", "truck", "a<b&c", "van"]
    jmetrics.write_per_class_csv(_metrics(), names, tmp_path / "j.csv")
    tmetrics.write_per_class_csv(_metrics(), names, tmp_path / "t.csv")
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def test_torch_per_class_xlsx_equals_jax_parts(tmp_path):
    """The workbooks unzipped part by part (the zip entries' timestamps
    differ between two writes)."""
    names = ["car", "truck", "a<b&c", "van"]
    jxlsx.write_per_class_xlsx(_metrics(), names, tmp_path / "j.xlsx")
    txlsx.write_per_class_xlsx(_metrics(), names, tmp_path / "t.xlsx")
    with zipfile.ZipFile(tmp_path / "j.xlsx") as zj, \
            zipfile.ZipFile(tmp_path / "t.xlsx") as zt:
        assert zt.namelist() == zj.namelist()
        for part in zj.namelist():
            assert zt.read(part) == zj.read(part), part


def test_torch_xyxy2xywh_equals_jax():
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 800, (3, 40, 2)).astype(np.float32)
    boxes = np.concatenate(
        [xy, xy + rng.uniform(1, 90, (3, 40, 2)).astype(np.float32)], -1)
    np.testing.assert_array_equal(
        tboxes.xyxy2xywh(torch.from_numpy(boxes)).numpy(),
        np.asarray(jboxes.xyxy2xywh(boxes)))


def test_torch_fitness_equals_jax():
    from sodt_tpu.train.evaluate import fitness_from_metrics as jfit
    from sodt_tpu_torch.train.trainer import fitness_from_metrics as tfit
    rows = np.random.default_rng(2).uniform(0, 1, (5, 7))
    np.testing.assert_array_equal(tmetrics.fitness(rows),
                                  jmetrics.fitness(rows))
    for mp, mr, map50, map_ in rows[:, :4]:
        m = dict(mp=mp, mr=mr, map50=map50, map=map_)
        assert tfit(m) == jfit(m)
    assert tfit({}) == jfit({}) == 0.0


def _close_numbers(got, want, unit):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=EXPORT_REL, atol=unit)


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_torch_evaluate_exports_match_jax(trained, folder, tmp_path, rect):
    """`save_json`, `save_txt` and `save_conf` of the trained flagship at
    256 px on the folder's 1024 px pairs: square (the first two pairs,
    boxes in the 256 px frame the dataset resized to) and rect (those and
    the 1024 x 768 pair, exported through each batch's own letterbox gain
    and pad)."""
    jm, v, tm = trained
    lst = str(folder["eval_list"] if rect else folder["val_list"])
    kw = dict(nc=8, img_size=IMG, conf_thres=CONF, save_conf=True)
    out = {}
    for tag in ("jax", "port"):
        d = tmp_path / tag
        d.mkdir()
        kw.update(save_json=str(d / "predictions.json"),
                  save_txt=str(d / "labels"))
        if tag == "jax":
            m = jevaluate(jm, v, jbatches(JDS(lst, img_size=IMG), 2, IMG,
                                          rect=rect), **kw)
        else:
            # a COCOeval pass is gated on pycocotools and on a readable
            # annotation file: either way the run reports it and goes on
            m = tevaluate(tm, make_eval_batches(TDS(lst, img_size=IMG), 2,
                                                IMG, rect=rect),
                          device="cpu", anno_json=str(d / "missing.json"),
                          **kw)
            assert "coco_map" not in m
        out[tag] = (m, json.loads((d / "predictions.json").read_text()),
                    {f.name: f.read_text().splitlines()
                     for f in sorted((d / "labels").iterdir())})
    (mj, jj, tj), (mt, jt, tt) = out["jax"], out["port"]
    assert mt["seen"] == mj["seen"]
    assert len(jt) == len(jj) > 0
    for a, b in zip(jt, jj):
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                      b["category_id"])
        _close_numbers(a["bbox"], b["bbox"], 1e-3)
        _close_numbers(a["score"], b["score"], 1e-5)
    assert sorted(tt) == sorted(tj) and len(tt) > 0
    for name, lines in tt.items():
        assert len(lines) == len(tj[name]), name
        for a, b in zip(lines, tj[name]):
            a, b = a.split(), b.split()
            assert len(a) == len(b) == 6 and a[0] == b[0]
            _close_numbers([float(x) for x in a[1:5]],
                           [float(x) for x in b[1:5]], 1e-6)
            _close_numbers(float(a[5]), float(b[5]), 1e-5)
    # one json record a txt line, and every box inside its image's frame
    assert len(jt) == sum(len(x) for x in tt.values())
    hw = {}
    for b in make_eval_batches(TDS(lst, img_size=IMG), 2, IMG, rect=rect):
        for stem, shape in zip(b["stems"], b["shapes"]):
            hw[int(stem) if stem.isnumeric() else stem] = shape
    for r in jt:
        x, y, w, h = r["bbox"]
        h0, w0 = hw[r["image_id"]]
        assert min(x, y, w, h) >= 0
        assert x + w <= w0 + 1e-3 and y + h <= h0 + 1e-3
    # rect: the portrait pair (resized to 256 x 192) sits in a 288 x 224
    # batch and is exported through that batch's gain and pad
    assert ((256, 192) in hw.values()) == rect


def test_torch_val_study_matches_jax(tmp_path, capsys):
    """`val --task study` at 128 and 256 px on SyntheticVedai(n=2) with the
    trained weights (the port reads the committed .npz, JAX its orbax
    checkpoint): one row per size, mAP within 5e-3."""
    jval = _load("jax_val_cli", ROOT / "val.py")
    common = ["--task", "study", "--study-sizes", "128,256", "--synthetic",
              "--synthetic-n", "2", "--batch-size", "2", "--no-bf16"]
    rows_t = val.main(common + [
        "--weights", str(ROOT / "checkpoints/flagship_r5_150ep_ema.npz"),
        "--device", "cpu", "--save-dir", str(tmp_path / "port")])["study"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rows_t
    jval.main(common + ["--weights",
                        str(ROOT / "runs/flagship_r5_150ep/best_stripped"),
                        "--platform", "cpu",
                        "--save-dir", str(tmp_path / "jax")])
    rows_j = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert [r["img_size"] for r in rows_t] == [128, 256]
    assert [r["img_size"] for r in rows_j] == [128, 256]
    for a, b in zip(rows_t, rows_j):
        for k in ("map50", "map"):
            assert abs(a[k] - b[k]) <= MAP_TOL, (a, b)
        assert a["speed_ms"] > 0
    assert rows_t[1]["map50"] > 0.5
    assert (tmp_path / "port" / "per_class.csv").exists()
    assert (tmp_path / "port" / "per_class.xlsx").exists()


def test_torch_val_accepts_every_jax_flag_and_refuses_plots(tmp_path):
    """Every flag of the JAX val.py parses in the port's val; --plots, no
    longer refused, writes the confusion matrix (its plot is held in
    tests/test_torch_port_run_logs.py)."""
    flags = set(re.findall(r'add_argument\("(--[\w-]+)"',
                           (ROOT / "val.py").read_text()))
    port = {s for act in val.parser()._actions for s in act.option_strings}
    assert flags and flags <= port, flags - port
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    m = val.main(["--plots", "--synthetic", "--synthetic-n", "2",
                  "--img-size", "64", "--batch-size", "2", "--cfg", str(cfg),
                  "--device", "cpu", "--no-bf16", "--save-dir", str(tmp_path)])
    assert (tmp_path / "confusion_matrix.png").exists()
    assert m["confusion_matrix"].shape == (9, 9)
