"""The port's coreset state and learning-rate schedule against the JAX
package's, and the numpy round trip that carries a JAX state into the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.coresets import state as jstate
from betacores_tpu.utils.opt import step_schedule as jschedule
from betacores_tpu_torch.coresets import state
from betacores_tpu_torch.utils.opt import step_schedule

torch.set_num_threads(1)


def _np(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_state_matches_jax(dtype):
    want = _np(jstate.init_state(9, 4, beta=0.3, dtype=getattr(jnp, dtype)))
    st = state.init_state(9, 4, beta=0.3, dtype=getattr(torch, dtype))
    got = state.state_to_numpy(st)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert st.m.shape == () and st.m.dtype == torch.int32
    assert (st.idcs == -1).all() and not st.slot_mask.any()


def test_round_trip_and_slot_mask_match_jax():
    rng = np.random.default_rng(0)
    js = jstate.warm_start_state(8, rng.uniform(size=3).astype(np.float32), [5, 1, 7],
                                 rng.normal(size=(3, 4)).astype(np.float32), beta=0.2,
                                 sampler_aux=jnp.asarray(rng.normal(size=4), jnp.float32))
    st = state.state_from_numpy(_np(js))
    back = state.state_to_numpy(st)
    for k, v in _np(js).items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)
    np.testing.assert_array_equal(st.slot_mask.numpy(), np.asarray(js.slot_mask))
    assert st.idcs.dtype == torch.int32 and st.m.dtype == torch.int32


def test_state_from_numpy_copies():
    arrays = _np(jstate.init_state(4, 2))
    st = state.state_from_numpy(arrays)
    st.wts[0] = 5.0
    assert arrays["wts"][0] == 0.0


def test_get_matches_jax():
    js = jstate.warm_start_state(6, np.asarray([0.5, 0.0, 2.0], np.float32), [4, 9, 2],
                                 np.arange(12, dtype=np.float32).reshape(3, 4))
    got = state.get(state.state_from_numpy(_np(js)))
    want = jstate.get(js)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("i0,n", [(1.0, 500), (0.5, 25), (0.1, 1)])
def test_step_schedule_matches_jax(i0, n):
    got = step_schedule(i0, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jschedule(i0, n)))
