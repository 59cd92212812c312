"""The trained flagship's committed weights, sodt_tpu_torch.train.checkpoint
and the trainer's checkpoint flags, on the CPU.

  * checkpoints/flagship_r5_150ep_ema.npz is bit-equal to the orbax EMA
    variables through from_jax_variables, and its sha256 is the sidecar's;
  * load_pretrained_variables counts (n_loaded, n_total) as JAX's does on
    the same model and source, also for a --single-cls model;
  * --resume: a narrow model trained 2 epochs straight against the same
    run cut after epoch 1 and resumed from its last.pt: parameters,
    BatchNorm statistics, optimizer state and EMA bit-equal in f32 (the
    streaming feed, augmentation off; deterministic algorithms on, since
    the CPU's index backward of the rel-pos tables sums in a thread-dependent
    order: two straight runs differ there by ~1e-11 without them);
  * --resume under --image-weights: the resumed epoch's order comes from
    the class weights alone (maps are not checkpointed, as in JAX);
  * val --weights takes the .npz and a checkpoint; --rect with
    --multi-scale is refused, as in JAX.
"""

from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.train import checkpoint as tck
from sodt_tpu_torch.weights import load_npz, save_npz

from torch_port_common import NARROW_CFG
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs/flagship_r5_150ep/best_stripped"
NPZ = ROOT / "checkpoints/flagship_r5_150ep_ema.npz"


def test_committed_npz_is_the_orbax_ema_bit_for_bit():
    import jax
    from sodt_tpu.train.checkpoint import eval_variables, load_checkpoint
    from sodt_tpu_torch.weights import from_jax_variables
    side = json.loads(NPZ.with_suffix(".json").read_text())
    assert hashlib.sha256(NPZ.read_bytes()).hexdigest() == side["sha256"]
    assert side["bytes"] == NPZ.stat().st_size
    ref = from_jax_variables(jax.tree.map(
        np.asarray, eval_variables(load_checkpoint(CKPT))))
    got = load_npz(NPZ)
    assert set(got) == set(ref) and len(got) == side["arrays"]
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k
    ev = side["jax_f32_eval"]
    assert ev["img_size"] == 512 and ev["seen"] == 16
    assert 0.9 < ev["map50"] <= 1 and 0 < ev["map"] < ev["map50"]
    # the full flagship state_dict loads strictly
    tbuild("configs/model.yaml", ch_in=4).load_state_dict(got)


@pytest.mark.parametrize("nc", [8, 1], ids=["flagship", "single_cls"])
def test_pretrained_counts_match_jax(nc, tmp_path):
    """(n_loaded, n_total) of JAX's load_pretrained_variables on its model
    from the orbax checkpoint, against the port's on its model from the
    .npz and from a port checkpoint holding the same EMA weights."""
    import jax
    import jax.numpy as jnp
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.train.checkpoint import load_pretrained_variables
    jm = jbuild(str(ROOT / "sodt_tpu/configs/model.yaml"), ch_in=4, nc=nc,
                input_mode="RGB+IR")
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    # the variables' structure is all the merge reads of them
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x0, x0,
                                       train=True))
    _, jn, jt = load_pretrained_variables(v, CKPT)
    pt = tmp_path / "w.pt"
    tck.write_checkpoint(pt, {"ema": load_npz(NPZ), "model": {}})
    sd = tbuild("configs/model.yaml", ch_in=4, nc=nc).state_dict()
    for src in (NPZ, pt):
        merged, tn, tt = tck.load_pretrained_variables(sd, src)
        assert (tn, tt) == (jn, jt), (src, tn, tt, jn, jt)
        assert set(merged) == set(sd)
    assert jn == jt if nc == 8 else jn == jt - 2      # Detect's conv differs


def _narrow(tmp_path, **hyp_over):
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    with open(ROOT / "sodt_tpu_torch/configs/hyp.scratch.yaml") as f:
        h = yaml.safe_load(f)
    hyp = tmp_path / "hyp.yaml"
    hyp.write_text(yaml.safe_dump(dict(h, warmup_iters=2, **hyp_over)))
    return ["--cfg", str(cfg), "--hyp", str(hyp), "--synthetic",
            "--synthetic-n", "4", "--img-size", "64", "--batch-size", "2",
            "--nbs", "4", "--no-bf16", "--device", "cpu"]


NO_AUG = dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, translate=0.0, scale=0.0,
              fliplr=0.0, mosaic=0.0, mixup=0.0)


class _Cut(Exception):
    pass


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_resume_is_bit_equal_to_the_straight_run(tmp_path, monkeypatch,
                                                 deterministic):
    from sodt_tpu_torch.data import loader
    from sodt_tpu_torch.train import cli
    monkeypatch.setattr(loader, "DEVICE_BANK_MAX_GB", 0.0)   # streaming
    common = _narrow(tmp_path, **NO_AUG) + ["--epochs", "2"]
    cli.main(common + ["--save-dir", str(tmp_path / "a"), "--notest"])

    def cut(state, m):                       # the run dies in epoch 2
        if state.step == 3:
            raise _Cut
    with pytest.raises(_Cut):
        cli.main(common + ["--save-dir", str(tmp_path / "b")], on_step=cut)
    first = tck.load_checkpoint(tmp_path / "b/last.pt")
    assert first["epoch"] == 0 and first["step"] == 2
    restored = {}

    def check(state):
        restored["ok"] = (
            all(torch.equal(v, first["model"][k])
                for k, v in state.model.state_dict().items())
            and all(torch.equal(v, first["ema"][k])
                    for k, v in state.ema.items())
            and state.step == first["step"])
    m = cli.main(["--resume", str(tmp_path / "b/last.pt")], on_start=check)
    assert restored["ok"] and m["steps"] == 4
    a = tck.load_checkpoint(tmp_path / "a/last.pt")
    b = tck.load_checkpoint(tmp_path / "b/last.pt")
    assert (a["epoch"], a["step"], a["ema_updates"]) == (
        b["epoch"], b["step"], b["ema_updates"]) == (1, 4, a["ema_updates"])
    for part in ("model", "ema"):
        assert set(a[part]) == set(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    oa, ob = a["opt_state"], b["opt_state"]
    assert (oa["count"], oa["ni"]) == (ob["count"], ob["ni"])
    assert oa["count"] > 0 and oa["trace"]
    for key in ("trace", "nu", "acc"):
        assert (oa[key] is None) == (ob[key] is None)
        for k in oa[key] or {}:
            assert torch.equal(oa[key][k], ob[key][k]), (key, k)


@pytest.mark.parametrize("ap", [0.0, 0.6], ids=["zero_maps", "eval_maps"])
def test_resume_under_image_weights(tmp_path, monkeypatch, deterministic,
                                    ap):
    """--image-weights across --resume. The checkpoint holds no per-class
    maps (nor does JAX's), so the resumed run draws its first epoch's order
    from the class weights alone. The uninterrupted run draws it from the
    last eval's maps. With an eval that reads all-zero maps the two runs
    are bit-equal; with maps of 0.6 the resumed epoch's image weights
    differ from the uninterrupted run's. The eval is a stand-in that
    returns `ap` for every class, so that the maps are known."""
    from sodt_tpu_torch.data import loader
    from sodt_tpu_torch.train import cli, trainer
    monkeypatch.setattr(loader, "DEVICE_BANK_MAX_GB", 0.0)   # streaming
    monkeypatch.setattr(trainer, "evaluate", lambda *a, nc, **k: {
        "map50": ap, "map": ap / 2,
        "per_class": {c: {"ap": ap} for c in range(nc)}})
    seen, image_weights = [], trainer.labels_to_image_weights

    def weights(labels, nc, cw):             # the class weights of each order
        seen.append(np.array(cw))
        return image_weights(labels, nc, cw)
    monkeypatch.setattr(trainer, "labels_to_image_weights", weights)
    common = _narrow(tmp_path) + ["--epochs", "2", "--image-weights"]
    cli.main(common + ["--save-dir", str(tmp_path / "a")])
    straight, seen[:] = list(seen), []

    def cut(state, m):
        if state.step == 3:
            raise _Cut
    with pytest.raises(_Cut):
        cli.main(common + ["--save-dir", str(tmp_path / "b")], on_step=cut)
    seen.clear()
    m = cli.main(["--resume", str(tmp_path / "b/last.pt")])
    assert m["steps"] == 4 and len(straight) == len(seen) == 2
    # epoch 0: maps zero in both; epoch 1: the resumed run's maps are zero
    np.testing.assert_array_equal(seen[0], straight[0])
    np.testing.assert_array_equal(seen[1], seen[0])
    a = tck.load_checkpoint(tmp_path / "a/last.pt")
    b = tck.load_checkpoint(tmp_path / "b/last.pt")
    assert (a["epoch"], a["step"]) == (b["epoch"], b["step"]) == (1, 4)
    if ap == 0.0:
        np.testing.assert_array_equal(straight[1], seen[1])
        for part in ("model", "ema"):
            for k in a[part]:
                assert torch.equal(a[part][k], b[part][k]), (part, k)
    else:
        np.testing.assert_allclose(straight[1], seen[1] * (1 - ap) ** 2,
                                   rtol=1e-12)


def test_checkpoint_files_and_val_weights(tmp_path, capsys):
    """--save-period / best.pt / --nosave (last.pt only at the end, the
    epoch snapshots still written), strip_checkpoint, and val --weights
    from the .npz and from the checkpoint (the same EMA weights give the
    same mAP)."""
    from sodt_tpu_torch import val
    from sodt_tpu_torch.train import cli
    common = _narrow(tmp_path) + ["--epochs", "2"]
    cli.main(common + ["--save-dir", str(tmp_path / "p"), "--multi-scale",
                       "--image-weights", "--single-cls"])
    assert {"last.pt", "best.pt", "opt.yaml", "hyp.yaml"} <= {
        p.name for p in (tmp_path / "p").iterdir()}
    run = tmp_path / "n"
    mid = {}

    def look(state, m):                      # epoch 0 ended and was saved
        if state.step == 3:
            mid.update(last=(run / "last.pt").exists(),
                       epoch0=(run / "epoch0.pt").exists())
    cli.main(common + ["--save-dir", str(run), "--nosave", "--save-period",
                       "1"], on_step=look)
    assert mid == {"last": False, "epoch0": True}
    assert not (run / "epoch1.pt").exists()
    last = tck.load_checkpoint(run / "last.pt")
    assert last["epoch"] == 1

    tck.strip_checkpoint(run / "last.pt", tmp_path / "strip.pt")
    stripped = tck.load_checkpoint(tmp_path / "strip.pt")
    assert set(stripped) == {"model", "epoch"}
    for k, v in last["ema"].items():
        assert torch.equal(stripped["model"][k], v)
    npz = tmp_path / "ema.npz"
    save_npz(tck.eval_variables(last), npz, compressed=True)
    vargs = [common[1], "--synthetic", "--synthetic-n", "2", "--img-size",
             "64", "--batch-size", "2", "--no-bf16", "--device", "cpu"]
    vargs = ["--cfg"] + vargs
    maps = [val.main(vargs + ["--weights", str(w)])["map"]
            for w in (npz, run / "last.pt")]
    assert maps[0] == maps[1]
    capsys.readouterr()


def test_rect_and_later_flags_still_raise(tmp_path):
    """Every flag of JAX's train.py is the port's now; what raises is JAX's
    refusal of --rect's mixes and of --super on a config without SR taps.
    --scan-epoch takes JAX's three values."""
    from sodt_tpu_torch.train import cli
    args = _narrow(tmp_path) + ["--epochs", "1"]
    flags = set(re.findall(r'add_argument\("(--[\w-]+)"',
                           (ROOT / "train.py").read_text()))
    port = {s for act in cli.parser()._actions for s in act.option_strings}
    assert flags and flags - {"--platform"} <= port, flags - port
    with pytest.raises(ValueError, match="--rect is incompatible"):
        cli.main(args + ["--rect", "--multi-scale"])
    with pytest.raises(SystemExit):
        cli.parser().parse_args(args + ["--scan-epoch", "always"])
    with pytest.raises(ValueError, match="SR taps"):
        cli.main(args + ["--super", "--factor", "2"])
