"""The training run of the port against the JAX package on the CPU: the
epoch loss and the event stream, the epoch path, remat, hyperparameter
evolution and SAM.

  * the epoch loss: JAX's `train()` and the port's on the same synthetic
    set (24 images, batch 2: 12 steps an epoch) from the same drawn
    weights of a small CNN log the same per-epoch losses to 1e-4 relative (the mean over
    ALL the epoch's steps, JAX's epoch path), and write events.jsonl
    records with the same keys. The port's per-step loop used to average
    only every LOG_EVERY-th step (steps 0 and 10 here);
  * the epoch path equals the per-step path bit for bit (parameters, BN
    statistics, EMA), also when it resumes; its logged losses are the
    all-step means of the losses `on_step` sees;
  * remat: the gradients of a remat model are bit-equal to those without,
    and within the three-step tolerance (1e-4 of a leaf's max) of JAX's
    `remat=True` model;
  * `mutate` / `log_generation` bit-equal to JAX's over three generations
    sharing one evolve.txt; `evolve` writes JAX's files;
  * SAM: three updates within 1e-6 of JAX's, at accumulate 1 and 2, and
    the sign of its ascent (JAX's: p - rho g / |g|).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sodt_tpu_torch.train import checkpoint as tck
from sodt_tpu_torch.train import cli, trainer as ttrainer

from torch_port_common import NARROW_CFG, drawn_variables
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
NO_AUG = dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, translate=0.0, scale=0.0,
              fliplr=0.0, mosaic=0.0, mixup=0.0)
STUB_EVAL = {"mp": 0.5, "mr": 0.25, "map50": 0.125, "map": 0.0625,
             "per_class": {}}


def _files(tmp_path, **hyp_over):
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    with open(ROOT / "sodt_tpu_torch/configs/hyp.scratch.yaml") as f:
        h = yaml.safe_load(f)
    hyp = tmp_path / "hyp.yaml"
    hyp.write_text(yaml.safe_dump(dict(h, **hyp_over)))
    return cfg, hyp


def _events(path):
    return [json.loads(line) for line in open(path)]


def test_epoch_losses_and_events_match_jax(tmp_path, monkeypatch):
    """One epoch of 12 steps in both trainers (the CNN of tests/tiny.yaml,
    RGB, 64 px, f32, the default learning rates, augmentation off so that
    both feeds give the same batches, the eval a stand-in). JAX's default
    feed is the epoch scan (one device: the conftest's eight-device mesh
    would not split batch 2); its epoch loss is the mean over all 12 steps,
    and so must the port's be."""
    import jax
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.parallel import make_mesh
    from sodt_tpu.train import trainer as jtrainer
    from sodt_tpu_torch.weights import from_jax_variables, save_npz

    _, hyp = _files(tmp_path, warmup_iters=4, **NO_AUG)
    cfg = ROOT / "tests/tiny.yaml"
    jm = jbuild(str(cfg), ch_in=3, nc=8, input_mode="RGB")
    x0 = np.zeros((2, 64, 64, 3), np.float32)
    v = drawn_variables(jm, x0, x0, seed=3, train=True)
    save_npz(from_jax_variables(v), tmp_path / "w.npz")

    class Drawn:                # JAX's model, initialized to the draws
        def __init__(self, m):
            self._m = m

        def __getattr__(self, k):
            return getattr(self._m, k)

        def init(self, *a, **k):
            return jax.tree.map(jax.numpy.asarray, v)

    real_build = jtrainer.build_model
    monkeypatch.setattr(jtrainer, "build_model",
                        lambda *a, **k: Drawn(real_build(*a, **k)))
    monkeypatch.setattr(jtrainer, "make_mesh", lambda: make_mesh(1))
    monkeypatch.setattr(jtrainer, "evaluate", lambda *a, **k: dict(STUB_EVAL))
    monkeypatch.setattr(ttrainer, "evaluate", lambda *a, **k: dict(STUB_EVAL))
    common = dict(cfg=str(cfg), hyp=str(hyp), synthetic=True, synthetic_n=24,
                  img_size=64, batch_size=2, nbs=2, epochs=1, bf16=False,
                  autoanchor=False, input_mode="RGB")
    jtrainer.train(jtrainer.TrainConfig(save_dir=str(tmp_path / "jax"),
                                        **common))
    m = ttrainer.train(ttrainer.TrainConfig(
        save_dir=str(tmp_path / "port"), weights_npz=str(tmp_path / "w.npz"),
        device="cpu", **common))
    jev = _events(tmp_path / "jax/events.jsonl")
    (jl,) = [e for e in jev if "train/box_loss" in e]
    assert m["steps"] == 12 and len(m["losses"]) == 1
    for k in ("box", "obj", "cls"):
        want = jl[f"train/{k}_loss"]
        assert abs(m["losses"][0][k] - want) <= 1e-4 * abs(want), (
            k, m["losses"][0][k], want)
    tev = _events(tmp_path / "port/events.jsonl")
    keys = lambda ev: sorted(tuple(sorted(e)) for e in ev)
    assert keys(tev) == keys(jev)
    (tl,) = [e for e in tev if "train/box_loss" in e]
    for k in ("box", "obj", "cls"):
        assert tl[f"train/{k}_loss"] == m["losses"][0][k]
    for k in ("x/lr0", "x/lr1", "x/lr2", "metrics/mAP_0.5"):
        assert abs(tl[k] - jl[k]) <= 1e-7, k


class _Cut(Exception):
    pass


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_epoch_path_equals_per_step_path_across_resume(tmp_path, monkeypatch,
                                                       deterministic,
                                                       capsys):
    """Two epochs (eval every epoch: chunks of one epoch) on the epoch path,
    on the per-step path (the bank, per step) and on the epoch path cut in
    its second epoch and resumed from last.pt: parameters, BN statistics,
    EMA and step bit-equal. The epoch path's logged losses are the means
    of every step's losses, which `on_step` sees; the per-step path's
    sample every LOG_EVERY-th step (here step 0 of each epoch)."""
    monkeypatch.setattr(ttrainer, "evaluate", lambda *a, **k: dict(STUB_EVAL))
    cfg, hyp = _files(tmp_path, warmup_iters=2)
    common = ["--cfg", str(cfg), "--hyp", str(hyp), "--synthetic",
              "--synthetic-n", "4", "--img-size", "64", "--batch-size", "2",
              "--nbs", "4", "--epochs", "2", "--no-bf16", "--device", "cpu",
              "--noautoanchor"]
    runs, steps = {}, {}
    for tag, flag in (("scan", "on"), ("step", "off")):
        seen = steps.setdefault(tag, [])
        runs[tag] = cli.main(common + ["--scan-epoch", flag, "--save-dir",
                                       str(tmp_path / tag)],
                             on_step=lambda s, m, seen=seen: seen.append(
                                 {k: float(v) for k, v in m.items()}))
    out = capsys.readouterr().out
    assert "epoch-scan dispatch over 1 device(s)" in out
    assert "feed: device bank (4 tiles on cpu)" in out      # per step
    for e in range(2):
        ep = steps["scan"][2 * e:2 * e + 2]
        for k in ep[0]:
            assert runs["scan"]["losses"][e][k] == float(
                np.mean(np.array([s[k] for s in ep], np.float32)))
            assert runs["step"]["losses"][e][k] == steps["step"][2 * e][k]
    assert steps["scan"] == steps["step"]

    def cut(state, m):
        if state.step == 3:
            raise _Cut
    with pytest.raises(_Cut):
        cli.main(common + ["--scan-epoch", "on", "--save-dir",
                           str(tmp_path / "cut")], on_step=cut)
    assert tck.load_checkpoint(tmp_path / "cut/last.pt")["epoch"] == 0
    cli.main(["--resume", str(tmp_path / "cut/last.pt")])
    a = tck.load_checkpoint(tmp_path / "scan/last.pt")
    for tag in ("step", "cut"):
        b = tck.load_checkpoint(tmp_path / tag / "last.pt")
        assert (a["step"], a["ema_updates"]) == (b["step"], b["ema_updates"])
        for part in ("model", "ema"):
            for k in a[part]:
                assert torch.equal(a[part][k], b[part][k]), (tag, part, k)


def test_remat_gradients_bit_equal_and_match_jax_remat(deterministic):
    """The loss gradients of the narrow flagship (64 px, batch 2, train
    mode) with remat are bit-equal to those without; both are held to JAX's
    remat=True model's at 1e-4 of each leaf's max, the three-step tests'
    bound."""
    import jax
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.train import loss as jloss
    from sodt_tpu_torch.models import build_model as tbuild
    from sodt_tpu_torch.train import loss as tloss
    from sodt_tpu_torch.weights import from_jax_tree, from_jax_variables

    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ir = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    tg = np.zeros((2, 4, 5), np.float32)
    tg[:, :3, 0] = rng.integers(0, 8, (2, 3))
    tg[:, :3, 1:3] = rng.uniform(0.2, 0.8, (2, 3, 2))
    tg[:, :3, 3:5] = rng.uniform(0.05, 0.3, (2, 3, 2))
    mask = np.zeros((2, 4), bool)
    mask[:, :3] = True
    jm = jbuild(NARROW_CFG, ch_in=4, input_mode="RGB+IR", remat=True)
    v = drawn_variables(jm, img, ir, seed=5, train=True)
    kw = dict(nc=8, anchors=jm.spec.anchors, strides=jm.spec.detect_strides,
              hyp_box=0.15, hyp_obj=0.03, hyp_cls=0.15)
    jcfg = jloss.LossConfig(**kw)

    def jtotal(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, img, ir,
                          train=True, mutable=["batch_stats"])
        return jloss.compute_loss(out["raw"], tg, mask, jcfg)[0]
    jg = from_jax_tree(jax.tree.map(np.asarray,
                                    jax.jit(jax.grad(jtotal))(v["params"])))

    grads = {}
    for remat in (False, True):
        tm = tbuild(NARROW_CFG, ch_in=4, remat=remat).train()
        tm.load_state_dict(from_jax_variables(v))
        out = tm(torch.from_numpy(img), torch.from_numpy(ir))
        total, _ = tloss.compute_loss(out["raw"], torch.from_numpy(tg),
                                      torch.from_numpy(mask),
                                      tloss.LossConfig(**kw))
        ps = dict(tm.named_parameters())
        grads[remat] = dict(zip(ps, torch.autograd.grad(total,
                                                        list(ps.values()))))
    assert set(grads[True]) == set(jg)
    for k, g in grads[False].items():
        assert torch.equal(grads[True][k], g), k
        w = jg[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * scale + 1e-7, (k, err, scale)


def test_mutate_and_log_generation_bit_equal_to_jax(tmp_path):
    """Three generations, each package on its own evolve.txt from the same
    seed and fitnesses: the same hyperparameters and the same file bytes
    (the first generation mutates the base, the later ones a parent drawn
    from the file)."""
    from sodt_tpu.train import evolve as jev
    from sodt_tpu_torch.train import evolve as tev
    assert tev.META == jev.META and len(tev.META) == 27
    with open(ROOT / "sodt_tpu_torch/configs/hyp.scratch.yaml") as f:
        base = yaml.safe_load(f)
    files = {p: tmp_path / f"{p}.txt" for p in ("jax", "port")}
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    for gen, fit in enumerate((0.3, 0.7, 0.5)):
        hj = jev.mutate(base, files["jax"], rj)
        ht = tev.mutate(base, files["port"], rt)
        assert ht == hj, gen
        assert ht != base
        jev.log_generation(files["jax"], fit, hj)
        tev.log_generation(files["port"], fit, ht)
        assert files["port"].read_bytes() == files["jax"].read_bytes()
    rows = np.loadtxt(files["port"], ndmin=2)
    assert rows.shape == (3, 28)


def test_evolve_writes_jax_files(tmp_path, monkeypatch):
    """`evolve` with `train` a stand-in (fitness by generation): the same
    evolve.txt, hyp_gen{N}.yaml and hyp_evolved.yaml as JAX's, byte for
    byte, and each generation trains with its own hyp file and directory."""
    from sodt_tpu.train import evolve as jev, trainer as jtr
    from sodt_tpu_torch.train import evolve as tev
    fits = [0.2, 0.6, 0.4]
    seen = {"jax": [], "port": []}

    def stub(tag):
        def train(tc):
            seen[tag].append((Path(tc.hyp).name, Path(tc.save_dir).name))
            return {"best_fitness": fits[len(seen[tag]) - 1]}
        return train
    monkeypatch.setattr(jtr, "train", stub("jax"))
    monkeypatch.setattr(ttrainer, "train", stub("port"))
    hyp = str(ROOT / "sodt_tpu_torch/configs/hyp.scratch.yaml")
    bj, fj = jev.evolve(jtr.TrainConfig(hyp=hyp, save_dir=str(
        tmp_path / "jax")), generations=3, seed=2)
    bt, ft = tev.evolve(ttrainer.TrainConfig(hyp=hyp, save_dir=str(
        tmp_path / "port")), generations=3, seed=2)
    assert (bt, ft) == (bj, fj) and ft == 0.6
    assert seen["port"] == seen["jax"] == [
        (f"hyp_gen{g}.yaml", f"gen{g}") for g in range(3)]
    names = lambda d: sorted(p.name for p in d.iterdir())
    assert names(tmp_path / "port") == names(tmp_path / "jax")
    for name in ("evolve.txt", "hyp_evolved.yaml", "hyp_gen0.yaml",
                 "hyp_gen1.yaml", "hyp_gen2.yaml"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name


SAM_HYP = dict(lr0=0.01, lrf=0.2, momentum=0.937, warmup_momentum=0.8,
               warmup_bias_lr=0.1, warmup_iters=1)


def _sam_tree(seed):
    """A named-parameter tree (port names, flax layout beside it): a 2-D
    weight, its bias, a BN scale; and the coefficients of a loss whose
    gradient differs from leaf to leaf."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(5, 3)).astype(np.float32)        # (out, in)
    b = rng.normal(size=5).astype(np.float32)
    s = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    coef = [rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
            for x in (w, b, s)]
    return (w, b, s), coef


def test_sam_ascent_sign_is_jax(tmp_path):
    """The first perturbation is -rho * g / ||g|| in both packages (optax
    negates the normalize -> scale(rho) transform's output)."""
    import jax
    import jax.numpy as jnp
    from sodt_tpu.train.sam import make_sam_optimizer as jsam
    from sodt_tpu_torch.train.sam import make_sam_optimizer as tsam
    (w, b, s), _ = _sam_tree(0)
    g = {"fc.weight": torch.ones(5, 3), "fc.bias": torch.full((5,), 2.0),
         "bn.weight": torch.zeros(5)}
    params = {"fc.weight": torch.from_numpy(w), "fc.bias": torch.from_numpy(b),
              "bn.weight": torch.from_numpy(s)}
    opt = tsam(SAM_HYP, params, epochs=3, nb=4, rho=0.05)
    adv = opt.adversarial_params(g, params)
    norm = np.sqrt(15 + 5 * 4.0)
    for k in g:
        np.testing.assert_allclose((adv[k] - params[k]).numpy(),
                                   -0.05 * g[k].numpy() / norm, atol=1e-7)
    jp = {"fc": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)},
          "bn": {"scale": jnp.asarray(s)}}
    jg = {"fc": {"kernel": jnp.ones((3, 5)), "bias": jnp.full((5,), 2.0)},
          "bn": {"scale": jnp.zeros(5)}}
    got = {}

    def grad_fn(p, i):
        got["adv"] = p
        return jax.tree.map(jnp.zeros_like, p)
    tx = jsam(SAM_HYP, jp, epochs=3, nb=4, rho=0.05)
    tx.update(jg, tx.init(jp), jp, grad_fn=grad_fn)
    np.testing.assert_allclose(np.asarray(got["adv"]["fc"]["bias"]) - b,
                               -0.05 * 2.0 / norm, atol=1e-7)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_sam_matches_jax(accumulate):
    """Three SAM updates of the port against JAX's, within 1e-6, the
    gradient of an elementwise loss at the current parameters going in.
    At accumulate 2 the gate fires at data iterations 0, 2 and 4 (warmup of
    one iteration). JAX's `make_sam_optimizer` at accumulate > 1 cannot
    take the `grad_fn` that its opaque SAM needs (its accumulation wrapper
    passes no keyword through: a TypeError, pinned here), so the port is
    held to what that wrapper lays out: JAX's own gate and JAX's inner SAM
    (`make_optimizer(wrap_accumulate=False)` inside `optax.contrib.sam`
    with normalize -> scale(rho)) fed the summed gradients."""
    import jax
    import jax.numpy as jnp
    import optax
    import optax.contrib
    from sodt_tpu.train import optim as jopt
    from sodt_tpu.train.sam import make_sam_optimizer as jsam
    from sodt_tpu_torch.train.sam import make_sam_optimizer as tsam
    (w, b, s), (cw, cb, cs) = _sam_tree(1)

    def jloss(p):
        return (jnp.sum(cw.T * jnp.sin(p["fc"]["kernel"]))
                + jnp.sum(cb * p["fc"]["bias"] ** 2)
                + jnp.sum(cs * jnp.exp(-p["bn"]["scale"])))

    def tloss(p):
        return ((torch.from_numpy(cw) * torch.sin(p["fc.weight"])).sum()
                + (torch.from_numpy(cb) * p["fc.bias"] ** 2).sum()
                + (torch.from_numpy(cs) * torch.exp(-p["bn.weight"])).sum())

    jgrad = jax.jit(jax.grad(jloss))

    def tgrad(p, i=0):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.items()}
        return dict(zip(leaves, torch.autograd.grad(tloss(leaves),
                                                    list(leaves.values()))))

    jp = {"fc": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)},
          "bn": {"scale": jnp.asarray(s)}}
    tp = {"fc.weight": torch.from_numpy(w.copy()),
          "fc.bias": torch.from_numpy(b.copy()),
          "bn.weight": torch.from_numpy(s.copy())}
    kw = dict(epochs=3, nb=4, rho=0.05, accumulate=accumulate)
    opt = tsam(SAM_HYP, tp, **kw)
    if accumulate == 1:
        jtx = jsam(SAM_HYP, jp, **kw)
        gate = lambda ni: True
    else:
        with pytest.raises(TypeError, match="grad_fn"):
            t = jsam(SAM_HYP, jp, **kw)
            t.update(jgrad(jp), t.init(jp), jp,
                     grad_fn=lambda p, i: jgrad(p))
        base = jopt.make_optimizer(SAM_HYP, jp, epochs=3, nb=4,
                                   accumulate=accumulate,
                                   wrap_accumulate=False)
        jtx = optax.contrib.sam(
            base, optax.chain(optax.contrib.normalize(), optax.scale(0.05)),
            opaque_mode=True)
        gate, _ = jopt.warmup_accumulate_plan(accumulate, 1)
    jst = jtx.init(jp)
    acc, fired = None, []
    for ni in range(3 * accumulate):
        g = jgrad(jp)
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        ups = opt.update(tgrad(tp), tp, grad_fn=tgrad)
        fired.append(opt.just_stepped)
        if gate(ni):
            jups, jst = jtx.update(acc, jst, jp,
                                   grad_fn=lambda p, i: jgrad(p))
            jp, acc = optax.apply_updates(jp, jups), None
        assert (ups is not None) == gate(ni)
        if ups is not None:
            for k, u in ups.items():
                tp[k] = tp[k] + u
        want = {"fc.weight": np.asarray(jp["fc"]["kernel"]).T,
                "fc.bias": np.asarray(jp["fc"]["bias"]),
                "bn.weight": np.asarray(jp["bn"]["scale"])}
        for k, v in want.items():
            np.testing.assert_allclose(tp[k].numpy(), v, rtol=0, atol=1e-6,
                                       err_msg=f"{k} at {ni}")
    assert sum(fired) == 3 and opt.base.count == 3
    assert not np.allclose(tp["fc.bias"].numpy(), b)
