"""Port parity: the user-axis batching helpers (``core/batching.py``).

From the same numpy trees -- plain leaves, an int8 leaf with a delta and
a frozen int8 leaf -- the port's ``stack_users``, ``install_user`` and
``take_user`` give the JAX package's arrays at atol 0, and keep its
quantized convention: ``q`` and ``scale`` are one
shared base (never copied per user), only ``delta`` is stacked, a frozen
leaf has no user axis. ``user_leaf_axes`` / ``user_state_axes`` name the
same axes as the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (repro.optim.quant needs it first)
from repro.core import batching as jb  # noqa: E402
from repro.core.engine import TrainState as JTrainState  # noqa: E402
from repro.optim import quant as jq  # noqa: E402
from repro_torch.core import batching as tb  # noqa: E402
from repro_torch.core.engine import TrainState  # noqa: E402
from repro_torch.optim import quant as tq  # noqa: E402

U = 3


def _user_tree(i):
    rng = np.random.default_rng(i)
    q = np.arange(-6, 6, dtype=np.int8).reshape(3, 4)
    return {
        "w": rng.normal(size=(4, 5)).astype(np.float32),
        "b": rng.normal(size=(5,)).astype(np.float32),
        "qd": (q, np.full((4,), 0.25, np.float32),
               rng.normal(size=(3, 4)).astype(np.float32)),
        "qf": (q, np.full((4,), 0.5, np.float32), None),
    }


def _jax(tree):
    return {k: jq.QuantizedLeaf(q=jnp.asarray(v[0]), scale=jnp.asarray(v[1]),
                                delta=None if v[2] is None
                                else jnp.asarray(v[2]),
                                orig_dtype=jnp.float32)
            if isinstance(v, tuple) else jnp.asarray(v)
            for k, v in tree.items()}


def _torch(tree):
    return {k: tq.QuantizedLeaf(q=torch.from_numpy(v[0]),
                                scale=torch.from_numpy(v[1]),
                                delta=None if v[2] is None
                                else torch.from_numpy(v[2].copy()))
            if isinstance(v, tuple) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, jq.QuantizedLeaf):
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(g.scale.numpy(),
                                          np.asarray(w.scale))
            assert (g.delta is None) == (w.delta is None), k
            if w.delta is not None:
                np.testing.assert_array_equal(g.delta.numpy(),
                                              np.asarray(w.delta))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=k)


def test_stack_install_take_match_jax_and_share_the_base():
    trees = [_user_tree(i) for i in range(U)]
    want = jb.stack_users([_jax(t) for t in trees])
    ttrees = [_torch(t) for t in trees]
    got = tb.stack_users(ttrees)
    _assert_same(got, want)
    # q / scale: the first tree's tensors, never copied per user
    assert got["qd"].q is ttrees[0]["qd"].q
    assert got["qf"] is ttrees[0]["qf"] and got["qf"].delta is None
    assert got["qd"].delta.shape == (U, 3, 4)

    new = _user_tree(10)
    want = jb.install_user(want, _jax(new), 1)
    assert tb.install_user(got, _torch(new), 1) is got
    _assert_same(got, want)
    for slot in range(U):
        _assert_same(tb.take_user(got, slot), jb.take_user(want, slot))


def test_train_state_stack_and_axes_match_jax():
    m, k = 4, 2
    states, jstates = [], []
    for i in range(U):
        opt = {"seeds": np.arange(m, dtype=np.int64) + i,
               "gs": np.full((m, k), i, np.float32),
               "coeffs": np.full((m, k), -i, np.float32)}
        t = _torch(_user_tree(i))
        states.append(TrainState(params=t, step=i + 2,
                                 opt={kk: torch.from_numpy(v)
                                      for kk, v in opt.items()}))
        jstates.append(JTrainState(
            params=_jax(_user_tree(i)), step=jnp.uint32(i + 2),
            opt={kk: jnp.asarray(v.astype(np.uint32) if kk == "seeds"
                                 else v) for kk, v in opt.items()}))
    got = tb.stack_users(states)
    want = jb.stack_users(jstates)
    assert got.step.tolist() == np.asarray(want.step).tolist()
    _assert_same(got.params, want.params)
    for kk in got.opt:
        np.testing.assert_array_equal(got.opt[kk].numpy(),
                                      np.asarray(want.opt[kk]))
    lane = tb.take_user(got, 1)
    assert lane.step == 3 and torch.equal(lane.opt["gs"],
                                          states[1].opt["gs"])

    axes = tb.user_state_axes(got)
    jaxes = jb.user_state_axes(want)
    assert axes.step == jaxes.step == 0
    assert axes.opt == jaxes.opt
    for key, ax in axes.params.items():
        jax_ax = jaxes.params[key]
        if isinstance(ax, tq.QuantizedLeaf):
            assert (ax.q, ax.scale, ax.delta) == (jax_ax.q, jax_ax.scale,
                                                  jax_ax.delta)
        else:
            assert ax == jax_ax == 0
    # the frozen leaf has no user axis, the delta'd one only its delta
    assert axes.params["qf"].delta is None and axes.params["qd"].delta == 0
    assert dataclasses.is_dataclass(axes.params["qd"])
    assert jax.tree_util.tree_leaves(jaxes.params["qf"]) == []
