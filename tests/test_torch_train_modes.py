"""The port's train step in its other modes against tpureg's: gradient
accumulation (against tpureg's fp64 step, as in test_torch_train.py, whose
module docstring says why) and bf16. Each compiles one more tpureg step, so
they sit in a file of their own, which another test worker can take.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_cli import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_refcache import refcache  # noqa: F401 (a fixture)
from test_torch_train import (  # noqa: F401 (jax_init is a fixture)
    TERMS,
    assert_stats_close,
    assert_update_close,
    host_state,
    jax_init,
    jax_make_train_step,
    port_state,
    predictor_sd,
    sd_of,
    x64_state,
)
from tpureg_torch.train import make_train_step


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_accumulated_step_matches_tpureg(jax_init):
    """``accum_steps=2`` against tpureg's (fp64): two microbatches of one
    pair, the second seeing the statistics the first left."""
    imgs, jstate = jax_init
    with jax.enable_x64(True):
        jstate = x64_state(jstate)
        step = jax_make_train_step(donate=False, accum_steps=2)
        jstate, jm = step(jstate, jnp.asarray(imgs, jnp.float64))
        want = host_state(jstate, adam=False)
    del jstate
    before = host_state(jax_init[1], adam=False)
    state = port_state(before)
    m = make_train_step(state, accum_steps=2)(torch.from_numpy(imgs))
    for k in TERMS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    sd = predictor_sd(state)
    assert_update_close(sd, sd_of(want), sd_of(before))
    assert_stats_close(sd, sd_of(want))


def test_bf16_step_matches_tpureg(jax_init):
    """One bf16 step on each side from the same fp32 weights. Both round
    weights and activations to bf16 (8 bits) through ~60 layers and their
    backward, in another order of operations: the loss terms agree to
    ≤ 2e-2 relative; the master weights stay fp32."""
    imgs, jstate = jax_init
    jstate = jstate.replace(opt_state=jstate.tx.init(jstate.params))
    _, jm = jax_make_train_step(donate=False, compute_dtype=jnp.bfloat16)(
        jstate, jnp.asarray(imgs))
    state = port_state(host_state(jstate, adam=False))
    m = make_train_step(state, compute_dtype=torch.bfloat16)(torch.from_numpy(imgs))
    for k in TERMS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-2, err_msg=k)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert state.step == 1
