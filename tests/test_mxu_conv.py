"""Blocked-Toeplitz MXU convolution (dsp/fir.py::_conv1d_mxu) equivalence.

An alternative lowering of the 41-tap channel/matched filters and the
64-chip syncword correlation as two matmuls per block; the pipeline keeps
the depthwise conv, so these tests call it explicitly.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from sondetpu.dsp.fir import _conv1d, _conv1d_mxu


@pytest.mark.parametrize("ntaps,stride,n", [
    (17, 1, 2100), (41, 2, 48000), (64, 1, 19231), (41, 4, 8192),
])
def test_mxu_conv_matches_depthwise(ntaps, stride, n):
    rng = np.random.default_rng(ntaps * 7 + stride)
    x = rng.normal(size=(3, n + ntaps - 1)).astype(np.float32)
    k = rng.normal(size=ntaps).astype(np.float32)
    got = np.asarray(_conv1d_mxu(jnp.asarray(x), jnp.asarray(k), stride))
    want = np.asarray(_conv1d(jnp.asarray(x), jnp.asarray(k), stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_mxu_conv_streaming_chunk_equivalence():
    """Overlap-save chunking through the MXU path == unchunked."""
    ntaps = 41
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9600 + ntaps - 1)).astype(np.float32)
    k = rng.normal(size=ntaps).astype(np.float32)
    full = np.asarray(_conv1d_mxu(jnp.asarray(x), jnp.asarray(k)))
    half = 4800
    a = np.asarray(_conv1d_mxu(jnp.asarray(x[:, :half + ntaps - 1]), jnp.asarray(k)))
    b = np.asarray(_conv1d_mxu(jnp.asarray(x[:, half:]), jnp.asarray(k)))
    np.testing.assert_allclose(np.concatenate([a, b], axis=1), full, atol=1e-4)
