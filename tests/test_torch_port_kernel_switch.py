"""The port's kernel switch (`sodt_tpu_torch.kernels.kernels_enabled`,
`no_kernels`, SODT_NO_KERNELS) against the JAX package's
(`sodt_tpu.pallas`), on the CPU:

  * `no_kernels()` nests and restores the previous state on exit, also
    when the block raises;
  * SODT_NO_KERNELS is read at each call, as JAX reads it;
  * `kernels_enabled()` and `int8_enabled()` equal JAX's for every
    combination of `int8_serving()`, `no_kernels()` and the variable, with
    JAX's backend test answered as on an accelerator (the port keeps the
    device a separate test: a CPU tensor takes the plain versions);
  * the narrow flagship under `int8_serving()` + `no_kernels()` is its bf16
    composition, not its int8 bodies.
"""

from __future__ import annotations

import itertools
from contextlib import nullcontext as _null

import numpy as np
import pytest
import torch

from sodt_tpu_torch import kernels
from torch_port_common import NARROW_CFG
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def no_env(monkeypatch):
    monkeypatch.delenv("SODT_NO_KERNELS", raising=False)


def test_no_kernels_nests_and_restores():
    assert kernels.kernels_enabled()
    with kernels.no_kernels():
        assert not kernels.kernels_enabled()
        with kernels.no_kernels():
            assert not kernels.kernels_enabled()
        assert not kernels.kernels_enabled()
    assert kernels.kernels_enabled()
    with pytest.raises(RuntimeError, match="inside"):
        with kernels.no_kernels():
            with kernels.no_kernels():
                raise RuntimeError("inside")
    assert kernels.kernels_enabled()


def test_environment_is_read_at_each_call(monkeypatch):
    monkeypatch.setenv("SODT_NO_KERNELS", "1")
    assert not kernels.kernels_enabled()
    with kernels.int8_serving():
        assert not kernels.int8_enabled()
    monkeypatch.setenv("SODT_NO_KERNELS", "")      # empty: unset, as in JAX
    assert kernels.kernels_enabled()
    monkeypatch.delenv("SODT_NO_KERNELS")
    assert kernels.kernels_enabled()
    with kernels.int8_serving():
        assert kernels.int8_enabled()
    assert not kernels.int8_enabled()


def test_switch_matches_jax_flag_by_flag(monkeypatch):
    import jax
    from sodt_tpu import pallas as jpallas
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for int8, off, env in itertools.product((False, True), (False, True),
                                            (None, "", "1")):
        if env is None:
            monkeypatch.delenv("SODT_NO_KERNELS", raising=False)
        else:
            monkeypatch.setenv("SODT_NO_KERNELS", env)
        with (kernels.int8_serving() if int8 else _null()), \
                (kernels.no_kernels() if off else _null()), \
                (jpallas.int8_serving() if int8 else _null()), \
                (jpallas.no_kernels() if off else _null()):
            case = (int8, off, env)
            assert kernels.kernels_enabled() == jpallas.kernels_enabled(), case
            assert kernels.int8_enabled() == jpallas.int8_enabled(), case
    # and each is restored
    monkeypatch.delenv("SODT_NO_KERNELS")
    assert kernels.kernels_enabled() and jpallas.kernels_enabled()
    assert not kernels.int8_enabled() and not jpallas.int8_enabled()


def test_int8_serving_inside_no_kernels_is_the_bf16_composition():
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    from sodt_tpu_torch.weights import init_weights
    m = cache_rel_bias(init_weights(
        build_model(NARROW_CFG, ch_in=4, dtype=torch.bfloat16), seed=3).eval())
    rng = np.random.default_rng(0)
    x, ir = (torch.from_numpy(rng.uniform(size=(2, 64, 64, 3))
                              .astype(np.float32)) for _ in range(2))
    kernels.reset_launches()
    with torch.no_grad():
        bf16 = m(x, ir)["raw"][0]
        with kernels.int8_serving():
            q8 = m(x, ir)["raw"][0]
            with kernels.no_kernels():
                composed = m(x, ir)["raw"][0]
            again = m(x, ir)["raw"][0]
    assert torch.equal(composed, bf16)
    assert torch.equal(again, q8)              # the int8 bodies came back
    rel = ((q8.float() - bf16.float()).norm() / bf16.float().norm()).item()
    assert rel > 1e-3                          # the control: int8 differs
    assert not any(kernels.launches().values())
