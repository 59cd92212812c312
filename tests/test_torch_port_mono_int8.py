"""int8 serving of the mono model (`model_mono.yaml`, RGB: the flagship's
Swin stages behind one patch embed) against the JAX package's int8 model,
as `test_torch_port_int8_model.py` holds the flagship: the port in bf16 on
the CPU inside `sodt_tpu_torch.kernels.int8_serving()`, JAX inside
`sodt_tpu.pallas.int8_serving()` with its gate opened on the CPU (both
`kernels_enabled` patched) and the Pallas bodies in interpret mode, on the
same weights at 128 px. The same blocks are quantized in the same order,
the port's own int8 weights are bit-equal to JAX's, and the raw Detect
maps hold JAX's to REL_L2 relative L2.

Each body on JAX's activations is held strip by strip (8 map rows, the
unit whose abs-max sets an activation's int8 scale): every strip within
BODY_REL_L2 of JAX's output but at most one a call. An f32 ulp between
the two packages' values ahead of a quantization point can move a strip's
abs-max, and then every code of that strip: on these weights K2's first
call reads 5.7e-3 in one of its four strips and 0 or 5.6e-4 in the
others, K7's first call 4.4e-3 in one of two and 0 in the other. A wrong
body would miss the bound in every strip. The bf16 body on the same
inputs must miss BODY_REL_L2 on the whole call (the control)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sodt_tpu.pallas as jpallas
import sodt_tpu.models.swin as jswin
from sodt_tpu.models import build_model as jbuild
from sodt_tpu.pallas import swin_block as jsb
from sodt_tpu_torch import kernels
from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.train.evaluate import cache_rel_bias
from sodt_tpu_torch.weights import from_jax_variables

from test_torch_port_int8_model import (BODIES, BODY_REL_L2, CALLS, REL_L2,
                                        _bf16, _port_raw, _rel_l2)
from torch_port_common import j, interpret_mode, randomize_variables
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MONO = "sodt_tpu/configs/model_mono.yaml"
PORT_MONO = "sodt_tpu_torch/configs/model_mono.yaml"
STRIP = 8       # map rows of a quantization strip


@pytest.fixture(scope="module")
def mono():
    img, seed = 128, 5
    x = np.random.default_rng(seed).uniform(0, 1, (1, img, img, 3)).astype(
        np.float32)
    jm = jbuild(MONO, ch_in=3, input_mode="RGB", dtype=jnp.bfloat16)
    init = jax.jit(lambda k, a: jm.init(k, a, a))
    v = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), j(x)))
    v = randomize_variables(v, seed)
    tm = tbuild(PORT_MONO, ch_in=3, input_mode="RGB",
                dtype=torch.bfloat16).eval()
    tm.load_state_dict(from_jax_variables(v))
    return jm, v, cache_rel_bias(tm), x


@pytest.fixture(scope="module")
def jax_int8(mono):
    """JAX's int8 raw maps and its int8 body calls in order."""
    jm, v, _, x = mono
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpallas, "kernels_enabled", lambda: True)
        mp.setattr(jswin, "kernels_enabled", lambda: True)
        for name in BODIES:
            mod = jsb if hasattr(jsb, name) else jpallas.window_attention
            def recorded(*a, _fn=getattr(mod, name), _name=name):
                out = _fn(*a)
                calls.append((_name, a, out))
                return out
            mp.setattr(mod, name, recorded)
        with jpallas.int8_serving(), interpret_mode():
            ref = np.asarray(jm.apply(v, j(x), j(x))["raw"][0], np.float32)
    assert calls and all(a[-1] is True for _, a, _ in calls)
    return ref, calls


@pytest.fixture(scope="module")
def port_int8(mono):
    """The port's int8 raw maps and its outer plain int8 body calls."""
    _, _, tm, x = mono
    calls, depth = [], [0]
    with pytest.MonkeyPatch.context() as mp:
        for jname, (mod, name, *_) in BODIES.items():
            def recorded(*a, _fn=getattr(mod, name), _name=jname, **kw):
                if not depth[0]:
                    calls.append((_name, a))
                depth[0] += 1
                try:
                    return _fn(*a, **kw)
                finally:
                    depth[0] -= 1
            mp.setattr(mod, name, recorded)
        kernels.reset_launches()
        with kernels.int8_serving():
            out = _port_raw(tm, x, x)
        assert not any(kernels.launches().values())   # CPU: no kernel launched
    return out, calls


def test_mono_int8_model_matches_jax_int8(mono, jax_int8, port_int8):
    ref, jcalls = jax_int8
    out, pcalls = port_int8
    assert [n for n, _ in pcalls] == [n for n, _, _ in jcalls]
    assert {n: [c for c, *_ in jcalls].count(n) for n in CALLS} == CALLS
    assert out.shape == ref.shape == (1, 32, 32, 3, 13)
    assert np.isfinite(out).all()
    assert _rel_l2(out, ref) <= REL_L2
    # the quantization moved the maps: int8 is not the bf16 forward
    assert _rel_l2(out, _port_raw(mono[2], mono[3], mono[3])) > 1e-3


@pytest.mark.parametrize("name", list(BODIES))
def test_mono_int8_bodies_match_jax(name, jax_int8, port_int8):
    """Every call of one body in the mono forward, on JAX's activations
    with the port's own weights and int8 weights."""
    _, jcalls = jax_int8
    _, pcalls = port_int8
    mod, q8_name, bf16_name, n_act, wpos = BODIES[name]
    pairs = [(p, jc) for p, jc in zip(pcalls, jcalls) if jc[0] == name]
    assert len(pairs) == CALLS[name]
    for (pname, pargs), (_, jargs, jout) in pairs:
        assert pname == name
        q8 = pargs[-1]
        for k, pos in wpos.items():
            wq, ws = (jsb._q8_weight_conv(jargs[pos]) if k == "wc"
                      else jsb._q8_weight(jargs[pos]))
            wq = np.asarray(wq)
            wq = wq.transpose(3, 0, 1, 2) if k == "wc" else wq.T
            np.testing.assert_array_equal(q8[k][0].numpy(), wq)
            np.testing.assert_array_equal(q8[k][1].numpy(),
                                          np.asarray(ws).reshape(-1))
        args = (*[_bf16(a) for a in jargs[:n_act]], *pargs[n_act:])
        ref = np.asarray(jnp.asarray(jout, jnp.float32))
        with torch.no_grad():
            out = getattr(mod, q8_name)(*args).float().numpy()
            bf = getattr(mod, bf16_name)(*args[:-1]).float().numpy()
        strips = [_rel_l2(out[:, r:r + STRIP], ref[:, r:r + STRIP])
                  for r in range(0, ref.shape[1], STRIP)]
        assert sum(e > BODY_REL_L2 for e in strips) <= 1, strips
        assert _rel_l2(bf, ref) > BODY_REL_L2      # the control
