"""Int8 gradient compression of the port (``repro_torch.optim.compression``)
held to the JAX package's (``repro.optim.compression``): the JAX test
suite's cases (``tests/test_optim.py``: bounded round-trip error, error
feedback converges, a 4x smaller wire) run on both packages, and seeded
inputs give the same int8 blocks and the same scale bits in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st

from repro.optim import compression as jcomp
from repro_torch.optim import compression as tcomp


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 5000), st.floats(0.01, 100.0))
def test_property_int8_roundtrip_bounded_error(n, scale):
    rng = np.random.default_rng(n)
    g = (rng.standard_normal(n) * scale).astype(np.float32)
    for mod, arr, absmax in (
            (jcomp, jnp.asarray(g), lambda x: float(jnp.abs(x).max())),
            (tcomp, torch.from_numpy(g), lambda x: float(x.abs().max()))):
        q, s = mod.compress_int8(arr)
        deq = mod.decompress_int8(q, s, arr.shape)
        blocks, _ = mod._pad_to_block(arr)
        tol = float(np.abs(np.asarray(blocks)).max()) / 127.0 + 1e-6
        assert absmax(deq - arr) <= tol


@pytest.mark.parametrize("n,scale", [(1, 1.0), (2047, 0.3), (2048, 7.0),
                                     (5000, 100.0), (6144, 1e-14)])
def test_seeded_blocks_and_scales_equal_jax_bits(n, scale):
    """Same int8 blocks, same f32 scale bits (the 1e-12 floor included at
    1e-14), same dequantized bits."""
    g = (np.random.default_rng(n).standard_normal(n) * scale).astype(
        np.float32)
    jq, js = jcomp.compress_int8(jnp.asarray(g))
    tq, ts = tcomp.compress_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    jd = jcomp.decompress_int8(jq, js, (n,))
    td = tcomp.decompress_int8(tq, ts, (n,))
    np.testing.assert_array_equal(td.numpy().view(np.uint32),
                                  np.asarray(jd).view(np.uint32))


def test_half_way_values_round_to_even_as_jax():
    """Values at k + 0.5 steps of the scale: jnp.round and torch.round
    both round half to even."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                 np.float32)
    jq, _ = jcomp.compress_int8(jnp.asarray(g))
    tq, _ = tcomp.compress_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


def test_error_feedback_converges():
    """EF-int8 compressed gradient descent converges in both packages,
    along the same trajectory (the port's params within 1e-6 of JAX's)."""
    target = np.linspace(-1, 1, 256).astype(np.float32)
    jp = {"w": jnp.zeros(256)}
    jerr = jcomp.init_error(jp)
    tp = {"w": torch.zeros(256)}
    terr = tcomp.init_error(tp)
    assert terr["w"].dtype == torch.float32 and not terr["w"].any()
    tt = torch.from_numpy(target)
    lr = 0.3
    for _ in range(80):
        g = jax.grad(lambda p: 0.5 * jnp.sum((p["w"] - target) ** 2))(jp)
        g_c, jerr = jcomp.ef_compressed_mean(g, jerr)
        jp = jax.tree.map(lambda p, gg: p - lr * gg, jp, g_c)
        tg = {"w": tp["w"] - tt}
        tg_c, terr = tcomp.ef_compressed_mean(tg, terr)
        tp = {"w": tp["w"] - lr * tg_c["w"]}
    assert float(0.5 * torch.sum((tp["w"] - tt) ** 2)) < 1e-3
    assert float(0.5 * jnp.sum((jp["w"] - target) ** 2)) < 1e-3
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=0, atol=1e-6)


def test_compressed_wire_is_4x_smaller():
    jq, js = jcomp.compress_int8(jnp.ones((4096,), jnp.float32))
    tq, ts = tcomp.compress_int8(torch.ones(4096))
    for wire in (jq.size + js.size * 4, tq.numel() + ts.numel() * 4):
        assert wire < 4096 * 4 / 3.5


def test_nested_dicts_keep_structure_and_dtype():
    g = {"a": {"w": torch.randn(3, 5, dtype=torch.bfloat16)},
         "b": torch.randn(7)}
    new_g, err = tcomp.ef_compressed_mean(g, tcomp.init_error(g))
    assert new_g["a"]["w"].dtype == torch.bfloat16
    assert new_g["a"]["w"].shape == (3, 5)
    assert err["a"]["w"].dtype == torch.float32 and err["b"].shape == (7,)


def test_a_data_axis_needs_a_process_group():
    """The mean over a data axis runs on a torch.distributed group
    (``tests/test_torch_compression_mean.py``); with none initialised it
    raises before it computes anything."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    g = {"w": torch.ones(4)}
    with pytest.raises(RuntimeError, match="process group"):
        tcomp.ef_compressed_mean(g, tcomp.init_error(g), axis_name="data")
