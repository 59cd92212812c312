"""The run's record and its helpers in the port against the JAX package on
the CPU: `utils.loggers.RunLogger`'s JSONL records, the W&B lifecycle on a
stub wandb module, the nine plot functions, `val --plots`, `detect
--save-img` and `Detections.save` (and the line each prints where
matplotlib is missing), `utils.profiler`, `utils.downloads` and the
helpers of `utils.general`.

`model_info`'s FLOPs are torch's FlopCounterMode over the plain versions
(matmuls, convolutions, attention), JAX's are XLA's cost analysis of the
lowered forward, which counts element-wise work too: on the narrow
flagship at 64 px the port counts 1.379 GFLOPs against JAX's 1.481, a
ratio of 0.931 (held to 0.9-0.96).
"""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sodt_tpu_torch.utils import general as tg
from sodt_tpu_torch.utils import plots as tplots

from torch_port_common import NARROW_CFG
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent


def test_run_logger_records_match_jax(tmp_path):
    """The same calls give the same records, "t" aside; every TAG that
    the inputs carry is logged."""
    from sodt_tpu.utils.loggers import TAGS as JTAGS, RunLogger as JLogger
    from sodt_tpu_torch.utils.loggers import TAGS, RunLogger
    assert TAGS == JTAGS
    rows = {}
    for tag, cls in (("jax", JLogger), ("port", RunLogger)):
        lg = cls(tmp_path / tag, use_tb=False)
        lg.log_epoch(0, {"box": 0.1, "obj": 0.2, "cls": 0.3, "loss": 0.6},
                     {"mp": 0.5, "mr": 0.6, "map50": 0.7, "map": 0.4,
                      "val_loss": {"box": 0.2, "obj": 0.1, "cls": 0.05}},
                     lrs=(0.01, 0.01, 0.1))
        lg.log_scalars({"wall/epoch": 1.5, "wall/chunk": 2}, 0)
        assert lg.wandb_id is None and not lg.lifecycle.active
        lg.close()
        rows[tag] = [{k: v for k, v in json.loads(line).items() if k != "t"}
                     for line in open(tmp_path / tag / "events.jsonl")]
    assert rows["port"] == rows["jax"]
    assert set(rows["port"][0]) - {"step"} == set(TAGS)


class _StubArtifact:
    def __init__(self, name, type=None, metadata=None):
        self.name, self.type, self.metadata = name, type, metadata
        self.files, self.dirs = [], []

    def add_file(self, p, name=None):
        self.files.append((p, name))

    def add_dir(self, p):
        self.dirs.append(p)


class _StubImage:
    def __init__(self, data, boxes=None):
        self.data, self.boxes = data, boxes


class _StubRun:
    id = "stubrun1"

    def __init__(self):
        self.artifacts, self.logged, self.finished = [], [], False

    def log_artifact(self, art, aliases=None):
        self.artifacts.append((art, aliases))

    def log(self, payload, step=None):
        self.logged.append((payload, step))

    def finish(self):
        self.finished = True


@pytest.fixture
def stub_wandb(monkeypatch):
    """A stub `wandb` in sys.modules, both packages' wandb_utils reloaded
    on it (and again on the real import state after)."""
    import importlib
    import sodt_tpu.utils.wandb_utils as jwu
    import sodt_tpu_torch.utils.wandb_utils as twu
    stub = types.ModuleType("wandb")
    stub.Artifact, stub.Image = _StubArtifact, _StubImage
    stub.init = lambda **kw: _StubRun()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    yield importlib.reload(jwu), importlib.reload(twu)
    monkeypatch.delitem(sys.modules, "wandb", raising=False)
    importlib.reload(jwu)
    importlib.reload(twu)


def _lifecycle_calls(wu, tmp):
    """Every call of the lifecycle on one stub run -> what the run saw."""
    run = _StubRun()
    lc = wu.WandbLifecycle(run)
    ckpt = tmp / "last"
    ckpt.mkdir(exist_ok=True)
    lc.log_model(ckpt, epoch=3, fitness=0.42, best=True)
    lc.log_model(tmp / "f.pt", epoch=4, fitness=0.1)
    lst = tmp / "fold01.txt"
    lst.write_text("a_co.png\n")
    lc.log_dataset({"train": str(lst), "val": str(tmp / "nope.txt"),
                    "nc": 8})
    dets = np.zeros((2, 4, 6), np.float32)
    dets[0, 0] = [8, 16, 24, 32, 0.9, 2]
    valid = np.zeros((2, 4), bool)
    valid[0, 0] = True
    media = lc.bbox_images(np.zeros((2, 64, 64, 3), np.uint8), dets, valid,
                           names=list("abcd"))
    lc.log_media("val/bboxes", media, step=1)
    arts = [(a.name, a.type, a.metadata, a.files, a.dirs, al)
            for a, al in run.artifacts]
    return arts, [m.boxes for m in media], [s for _, s in run.logged]


def test_wandb_lifecycle_matches_jax_on_a_stub(stub_wandb, tmp_path):
    jwu, twu = stub_wandb
    assert twu.is_wandb_artifact("wandb-artifact://ent/proj/run_x_model")
    assert not twu.is_wandb_artifact("runs/train/exp/last.pt")
    want = _lifecycle_calls(jwu, tmp_path)
    got = _lifecycle_calls(twu, tmp_path)
    assert got == want
    assert got[0][0][5] == ["latest", "epoch3", "best"]
    lc = twu.WandbLifecycle(None)
    assert not lc.active and lc.log_model("x", epoch=0, fitness=0.0) is None


def test_run_logger_with_wandb_and_resume_without_it(stub_wandb, tmp_path):
    """--wandb through the logger: scalars reach the run, its id is the
    logger's; without wandb a wandb-artifact:// resume raises, naming it."""
    from sodt_tpu_torch.utils.loggers import RunLogger
    lg = RunLogger(tmp_path, use_tb=False, use_wandb=True, config={"a": 1})
    lg.log_scalars({"wall/epoch": 1.0}, 3)
    run = lg.wandb_run
    lg.close()
    assert lg.wandb_id == "stubrun1" and run.finished
    assert run.logged == [({"wall/epoch": 1.0}, 3)]
    sys.modules.pop("wandb")
    import importlib
    twu = importlib.reload(sys.modules["sodt_tpu_torch.utils.wandb_utils"])
    with pytest.raises(RuntimeError, match="wandb not installed"):
        twu.resolve_artifact_checkpoint("wandb-artifact://e/p/run_x_model")


def _plot_calls(tmp):
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(2, 32, 32, 3))
    targets = np.zeros((2, 3, 5), np.float32)
    targets[:, 0] = [1, 0.5, 0.5, 0.2, 0.2]
    masks = np.zeros((2, 3), bool)
    masks[:, 0] = True
    ev = tmp / "ev.jsonl"
    ev.write_text(json.dumps({"t": 0, "step": 0, "a": 1.0, "b": 2.0}) + "\n"
                  + json.dumps({"t": 1, "step": 1, "a": 0.5, "b": 1.0}) + "\n")
    ef = tmp / "evolve.txt"
    np.savetxt(ef, rng.uniform(0.0, 1.0, (5, 28)))
    px = np.linspace(0, 1, 1000)
    return {
        "images": (tplots.plot_images, (imgs, targets, masks,
                                        tmp / "batch.png", ["a", "b", "c"])),
        "pr_curve": (tplots.plot_pr_curve, (
            px, [np.linspace(1, 0, 1000)] * 2,
            np.full((2, 10), 0.5), tmp / "pr.png", ["a", "b"])),
        "mc_curve": (tplots.plot_mc_curve, (
            px, rng.uniform(size=(2, 1000)), tmp / "f1.png", ["a", "b"])),
        "confusion_matrix": (tplots.plot_confusion_matrix, (
            rng.uniform(size=(4, 4)), tmp / "cm.png", ["a", "b", "c"])),
        "labels": (tplots.plot_labels, (targets[:, 0], tmp, 3)),
        "results": (tplots.plot_results, (ev, tmp / "res.png")),
        "evolution": (tplots.plot_evolution, (ef, tmp / "evolve.png")),
        "study": (tplots.plot_study, (
            [{"img_size": 256, "map50": 0.3, "map": 0.1, "speed_ms": 3.0},
             {"img_size": 512, "map50": 0.5, "map": 0.2, "speed_ms": 7.0}],
            tmp / "study.png")),
        "lr_schedule": (tplots.plot_lr_schedule, (
            (lambda s: 0.01 * (1 - s / 100), lambda s: 0.1 / (s + 1)), 100,
            tmp / "lr.png")),
    }


PLOTS = ["images", "pr_curve", "mc_curve", "confusion_matrix", "labels",
         "results", "evolution", "study", "lr_schedule"]


@pytest.mark.parametrize("name", PLOTS)
def test_plot_writes_its_file(name, tmp_path):
    fn, args = _plot_calls(tmp_path)[name]
    out = fn(*args)
    assert out is not None and out.stat().st_size > 1000, name


@pytest.fixture
def no_matplotlib(monkeypatch):
    for k in [k for k in sys.modules if k.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_plots_write_nothing_without_matplotlib(tmp_path, no_matplotlib):
    assert "matplotlib is not installed" in tplots.missing_reason()
    for name, (fn, args) in _plot_calls(tmp_path).items():
        assert fn(*args) is None, name
    assert not list(tmp_path.glob("*.png"))


def _narrow(tmp_path):
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    return str(cfg)


def _png_folder(tmp_path):
    from sodt_tpu_torch.data.png import write_png
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(1)
    for i, hw in enumerate(((60, 80), (72, 64))):
        write_png(src / f"{i}.png", rng.integers(0, 256, (*hw, 3),
                                                 dtype=np.uint8))
    return src


@pytest.mark.parametrize("mpl", [True, False], ids=["matplotlib", "none"])
def test_val_plots_detect_save_img_and_detections_save(tmp_path, capsys,
                                                       monkeypatch, mpl):
    """val --plots writes confusion_matrix.png (--task study: study.png),
    detect --save-img one PNG an image, Detections.save image{i}.png; with
    matplotlib hidden each writes nothing and says so on one line."""
    from sodt_tpu_torch import detect, val
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.models.infer import Predictor
    from sodt_tpu_torch.weights import init_weights
    if not mpl:
        for k in [k for k in sys.modules if k.split(".")[0] == "matplotlib"]:
            monkeypatch.delitem(sys.modules, k)
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = _narrow(tmp_path)
    out = tmp_path / "out"
    common = ["--cfg", cfg, "--device", "cpu", "--no-bf16", "--save-dir",
              str(out)]
    m = val.main(common + ["--plots", "--synthetic", "--synthetic-n", "2",
                           "--img-size", "64", "--batch-size", "2"])
    assert m["confusion_matrix"].shape == (9, 9)
    val.main(common + ["--plots", "--task", "study", "--study-sizes", "64",
                       "--synthetic", "--synthetic-n", "2",
                       "--batch-size", "2"])
    src = _png_folder(tmp_path)
    detect.main(common + ["--source", str(src), "--img-size", "64",
                          "--input_mode", "RGB+IR",
                          "--save-img", "--conf-thres", "0.001"])
    model = build_model(cfg, ch_in=4)
    init_weights(model, seed=0)
    dets = Predictor(model.eval(), 64)([np.zeros((40, 50, 3), np.uint8)] * 2)
    saved = dets.save(tmp_path / "saved")
    text = capsys.readouterr().out
    pngs = sorted(p.name for p in out.glob("*.png"))
    if mpl:
        assert pngs == ["0.png", "1.png", "confusion_matrix.png", "study.png"]
        assert [p.name for p in saved] == ["image0.png", "image1.png"]
        assert all(p.stat().st_size > 1000 for p in saved)
        assert "no plot written" not in text
    else:
        assert pngs == [] and saved == []
        for line in ("--plots: no plot written: matplotlib is not installed",
                     "--save-img: no image written: matplotlib is not",
                     "Detections.save: no image written: matplotlib"):
            assert line in text, line


def test_model_info_and_flops_against_jax():
    """Parameters equal to JAX's model_info; GFLOPs at 0.9-0.96 of JAX's
    (module doc)."""
    import jax
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.utils.profiler import model_info as jinfo
    from sodt_tpu_torch.models import build_model as tbuild
    from sodt_tpu_torch.utils.profiler import model_info
    from torch_port_common import drawn_variables
    jm = jbuild(NARROW_CFG, ch_in=4, input_mode="RGB+IR")
    x = np.zeros((1, 64, 64, 3), np.float32)
    v = jax.tree.map(jax.numpy.asarray,
                     drawn_variables(jm, x, x, train=False))
    want = jinfo(jm, v, img_size=64)
    tm = tbuild(NARROW_CFG, ch_in=4)
    got = model_info(tm, img_size=64)
    assert got["params"] == sum(p.size for p in jax.tree.leaves(
        v["params"])) == round(want["params_m"] * 1e6)
    ratio = got["gflops"] / want["gflops"]
    assert 0.9 <= ratio <= 0.96, (got, want)


def test_time_fn_and_trace(tmp_path):
    from sodt_tpu_torch.utils.profiler import flops_estimate, time_fn, trace
    a = torch.ones(64, 64)
    r = time_fn(torch.matmul, a, a, iters=3, warmup=1)
    assert r["seconds"] > 0 and r["timer"] == "wall"
    assert flops_estimate(torch.matmul, a, a) == 2 * 64 ** 3
    with trace(tmp_path / "t" / "trace.json"):
        torch.matmul(a, a)
    ev = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any("matmul" in e.get("name", "") for e in ev["traceEvents"])


def test_attempt_download_local_file_url_and_base(tmp_path, monkeypatch):
    """Local paths pass through; a file:// URL lands in the cache keyed by
    the URL, as JAX's does; SODT_WEIGHTS_BASE fetches a missing path; a
    short download is refused and leaves no file."""
    from sodt_tpu.utils.downloads import attempt_download as jdl
    from sodt_tpu_torch.utils.downloads import attempt_download
    src = tmp_path / "weights.pt"
    src.write_bytes(b"x" * 150_000)
    assert attempt_download(str(src)) == str(src)
    assert attempt_download("") == ""
    monkeypatch.setenv("SODT_WEIGHTS_CACHE", str(tmp_path / "cache"))
    got = attempt_download(src.as_uri())
    assert got == jdl(src.as_uri())
    assert Path(got).read_bytes() == src.read_bytes()
    assert Path(got).parent.parent == tmp_path / "cache"
    monkeypatch.setenv("SODT_WEIGHTS_BASE", tmp_path.as_uri())
    dst = tmp_path / "sub" / "weights.pt"
    assert attempt_download(str(dst)) == str(dst)
    assert dst.read_bytes() == src.read_bytes()
    monkeypatch.delenv("SODT_WEIGHTS_BASE")
    assert attempt_download(str(tmp_path / "nope.pt")) == str(
        tmp_path / "nope.pt")
    tiny = tmp_path / "tiny.bin"
    tiny.write_bytes(b"z")
    with pytest.raises(OSError, match="too small"):
        attempt_download(str(tmp_path / "d" / "tiny.bin"), url=tiny.as_uri(),
                         min_bytes=32)
    assert not (tmp_path / "d" / "tiny.bin").exists()


def test_general_helpers_match_jax(tmp_path, capsys):
    from sodt_tpu.utils import general as jg
    for size, s in ((500, 32), (512, 32), (100, 64)):
        assert tg.check_img_size(size, s) == jg.check_img_size(size, s)
    assert capsys.readouterr().out.count("must be multiple") == 4
    for args in (("text",), ("red", "bold", "x"), ("green", "underline",
                                                   "y")):
        assert tg.colorstr(*args) == jg.colorstr(*args)
    assert tg.clean_str("a|b@c#d:e") == jg.clean_str("a|b@c#d:e") == (
        "a_b_c_d_e")
    run = tmp_path / "exp"
    assert tg.increment_path(run) == jg.increment_path(run) == run
    run.mkdir()
    (tmp_path / "exp2").mkdir()
    assert tg.increment_path(run) == jg.increment_path(run) == (
        tmp_path / "exp3")
    assert tg.increment_path(run, exist_ok=True) == run
    assert tg.get_latest_run(str(tmp_path)) == jg.get_latest_run(
        str(tmp_path)) == ""
    (run / "last.pt").write_bytes(b"1")
    assert tg.get_latest_run(str(tmp_path)) == jg.get_latest_run(
        str(tmp_path)) == str(run / "last.pt")
    tg.set_logging(0)
    want = yaml.safe_load(open(jg.resolve_config_path("hyp.scratch.yaml")))
    assert yaml.safe_load(open(tg.resolve_config_path(
        "configs/hyp.scratch.yaml"))) == want
    assert tg.resolve_config_path("hyp.scratch.yaml").startswith(
        str(ROOT / "sodt_tpu_torch"))
