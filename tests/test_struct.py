"""core/struct.py: frozen pytree dataclasses with .replace and static
fields, and the render state's checkpoint round trip through them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hobbyraytracer_tpu.core import struct


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray = None
    tag: str = struct.field(pytree_node=False, default="x")


def test_tree_round_trip():
    p = _Pair(a=jnp.arange(3.0), b=jnp.ones((2,)), tag="t")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert q.tag == "t"
    np.testing.assert_array_equal(q.a, p.a)
    doubled = jax.tree.map(lambda x: 2 * x, p)
    np.testing.assert_array_equal(doubled.b, 2 * p.b)


def test_replace_and_frozen():
    p = _Pair(a=jnp.zeros(2))
    q = p.replace(b=jnp.ones(2), tag="y")
    assert q.tag == "y" and p.tag == "x" and p.b is None
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)


def test_static_field_is_part_of_the_jit_key():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.tag)
        return p.a * 2

    f(_Pair(a=jnp.ones(2), tag="one"))
    f(_Pair(a=jnp.zeros(2), tag="one"))
    f(_Pair(a=jnp.ones(2), tag="two"))
    assert traces == ["one", "two"]


def test_pool_state_checkpoint_round_trip(tmp_path):
    from hobbyraytracer_tpu.integrator import wavefront
    from hobbyraytracer_tpu.io import checkpoint

    s = wavefront.init_state(4, 3, pool=8).replace(counter=jnp.int32(5))
    path = str(tmp_path / "ck.npz")
    checkpoint.save_state(path, s)
    back = checkpoint.load_state(path)
    for x, y in zip(jax.tree_util.tree_leaves(s),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert int(back.counter) == 5
