"""FIR filter design and batched streaming (overlap-save) application.

Replaces the reference's reliance on SDR++ core filtering (the polyphase
resampler's embedded FIR, main.hpp:7, and sondedump's matched filters,
SURVEY.md S0). Filters are designed host-side in NumPy (windowed-sinc /
Gaussian) and baked as constants into the jitted pipeline; streaming
application keeps a per-channel tail of ``ntaps-1`` samples so chunked
filtering is exactly equal to filtering the unchunked stream.

The convolution itself is a batched grouped 1-D convolution (XLA hands it
to cuDNN on a GPU) that never materializes the sliding windows.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Filter design (host-side, NumPy)
# ---------------------------------------------------------------------------

def _blackman_harris(n: int) -> np.ndarray:
    k = np.arange(n)
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    return (a0 - a1 * np.cos(2 * np.pi * k / (n - 1))
            + a2 * np.cos(4 * np.pi * k / (n - 1))
            - a3 * np.cos(6 * np.pi * k / (n - 1)))


def design_lowpass(cutoff_hz: float, fs: float, ntaps: int) -> np.ndarray:
    """Windowed-sinc lowpass, Blackman-Harris window, unity DC gain.

    ``ntaps`` must be odd: callers size overlap-save carries from the
    value they pass, so a silent +1 bump would desynchronize state shapes
    (FIRState tails, halo widths) from the actual filter length."""
    if ntaps % 2 == 0:
        raise ValueError(f"ntaps must be odd, got {ntaps}")
    n = np.arange(ntaps) - (ntaps - 1) / 2
    fc = cutoff_hz / fs
    h = np.sinc(2 * fc * n) * 2 * fc
    h *= _blackman_harris(ntaps)
    h /= h.sum()
    return h.astype(np.float32)


def gaussian_taps(bt: float, sps: float, span: int = 4) -> np.ndarray:
    """Gaussian pulse-shaping filter for GFSK (BT product ``bt``).

    Used by the modulators (test-fixture synthesis, SURVEY.md §4 item 1) and
    as an approximate matched filter.
    """
    ntaps = int(span * sps) | 1
    t = (np.arange(ntaps) - (ntaps - 1) / 2) / sps
    sigma = np.sqrt(np.log(2)) / (2 * np.pi * bt)
    h = np.exp(-(t ** 2) / (2 * sigma ** 2))
    h /= h.sum()
    return h.astype(np.float32)


def boxcar_taps(sps: int) -> np.ndarray:
    """Integrate-and-dump matched filter for rectangular NRZ pulses."""
    return (np.ones(sps) / sps).astype(np.float32)


# ---------------------------------------------------------------------------
# Batched streaming FIR (overlap-save)
# ---------------------------------------------------------------------------

class FIRState(NamedTuple):
    """Per-channel carry-over: the last ``ntaps-1`` input samples."""

    tail: jax.Array  # [channels, ntaps-1]


def fir_init(channels: int, ntaps: int, dtype=jnp.float32) -> FIRState:
    return FIRState(tail=jnp.zeros((channels, ntaps - 1), dtype=dtype))


def _sliding_windows(x: jax.Array, ntaps: int) -> jax.Array:
    """[batch, n + ntaps - 1] -> [batch, n, ntaps] sliding windows.

    Built from ``ntaps`` shifted slices; XLA fuses these into a single
    strided read, and the subsequent contraction is a small matmul.
    """
    n = x.shape[-1] - ntaps + 1
    cols = [jax.lax.dynamic_slice_in_dim(x, k, n, axis=-1) for k in range(ntaps)]
    return jnp.stack(cols, axis=-1)


def fir_filter(x: jax.Array, taps: jax.Array) -> jax.Array:
    """Causal batched FIR: y[n] = sum_k h[k] * x[n - k], zero initial state.

    x: [channels, n]; returns [channels, n].
    """
    taps = jnp.asarray(taps)
    ntaps = taps.shape[0]
    xp = jnp.pad(x, ((0, 0), (ntaps - 1, 0)))
    return _apply_windows(xp, taps)


def _apply_windows(xp: jax.Array, taps: jax.Array, stride: int = 1) -> jax.Array:
    """[batch, n + ntaps - 1] padded input -> [batch, n // stride] causal FIR.

    Lowered as a batched 1-D convolution (never materializes the
    [batch, n, ntaps] window tensor — that would be ~TBs at 1000 channels).
    stride > 1 fuses decimation into the filter: only every stride-th output
    is computed (the polyphase-decimator cost model).
    """
    ntaps = taps.shape[0]
    if jnp.iscomplexobj(xp):
        h_rev = taps[::-1].astype(jnp.float32)
        return (_conv1d(xp.real, h_rev, stride) + 1j * _conv1d(xp.imag, h_rev, stride))
    return _conv1d(xp, taps[::-1], stride)


def _group_size(channels: int) -> int:
    """Feature-group split for the batched depthwise conv.

    Channels fold into the conv's feature dimension (feature_group_count
    g) over a batch of N = channels/g rows. The rule was tuned on the
    accelerator this code was first written for and has not been re-derived
    on the current one (ROADMAP §C3):

    - channels <= 256: one row, g = channels;
    - channels % 8 == 0: N = 8 rows;
    - otherwise the largest power-of-two divisor up to 256.
    """
    if channels <= 256:
        return channels
    if channels % 8 == 0:
        return channels // 8
    for g in (256, 128, 64, 32, 16, 8, 4, 2):
        if channels % g == 0:
            return g
    return 1


def _conv1d_mxu(x: jax.Array, kernel: jax.Array, stride: int = 1,
                block: int = 128) -> jax.Array:
    """Valid 1-D correlation as two matmuls (blocked Toeplitz).

    Blocking time into windows of ``block`` outputs turns the FIR into
    y_win = A @ H0 + B @ H1 with dense [block, block] / [ntaps-1, block]
    Toeplitz tap matrices — (block+ntaps-1)/ntaps more FLOPs, but as
    matmuls. H columns are strided for fused decimation.
    x: [C, n + ntaps - 1] with kernel pre-reversed (correlation), like
    lax.conv.

    A matmul cannot beat an op whose cost is memory reads, and this path
    lost to the depthwise conv where it was first tried. Kept (with tests)
    as that negative result (ROADMAP §C4); the hot path stays on the
    depthwise conv in _conv1d.
    """
    c, ln = x.shape
    ntaps = kernel.shape[0]
    n = ln - ntaps + 1                      # valid outputs at stride 1
    T = block
    if T % stride:
        raise ValueError(
            f"block {T} must be a stride ({stride}) multiple: each block "
            "restarts the stride grid at its own boundary")
    nblk = -(-n // T)
    xp = jnp.pad(x, ((0, 0), (0, nblk * T + T - ln)))
    A = xp[:, : nblk * T].reshape(c, nblk, T)
    B = xp[:, T: T + nblk * T].reshape(c, nblk, T)[:, :, : ntaps - 1]
    kernel = jnp.asarray(kernel, jnp.float32)
    j = jnp.arange(0, T, stride)[None, :]
    d0 = jnp.arange(T)[:, None] - j
    h0 = jnp.where((d0 >= 0) & (d0 < ntaps),
                   kernel[jnp.clip(d0, 0, ntaps - 1)], 0.0)
    d1 = (T + jnp.arange(ntaps - 1))[:, None] - j
    h1 = jnp.where((d1 >= 0) & (d1 < ntaps),
                   kernel[jnp.clip(d1, 0, ntaps - 1)], 0.0)
    y = (jnp.einsum("cmt,tj->cmj", A.astype(jnp.float32), h0)
         + jnp.einsum("cmd,dj->cmj", B.astype(jnp.float32), h1))
    return y.reshape(c, -1)[:, : -(-n // stride)]


def _conv1d(x: jax.Array, kernel: jax.Array, stride: int = 1) -> jax.Array:
    """Always accumulates and returns float32; a bfloat16 input stays
    bfloat16 on the conv's HBM read (the convs are memory-bound — SURVEY
    compute-dtype lever), f32 otherwise."""
    c, n = x.shape
    in_dt = jnp.bfloat16 if x.dtype == jnp.bfloat16 else jnp.float32
    kernel = jnp.asarray(kernel, in_dt)
    g = _group_size(c)
    if g > 1:
        out = jax.lax.conv_general_dilated(
            x.reshape(c // g, g, n).astype(in_dt),
            jnp.tile(kernel[None, None, :], (g, 1, 1)),
            window_strides=(stride,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            feature_group_count=g,
            preferred_element_type=jnp.float32)
        return out.reshape(c, -1)
    out = jax.lax.conv_general_dilated(
        x[:, None, :].astype(in_dt), kernel[None, None, :],
        window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32)
    return out[:, 0, :]


@partial(jax.jit, static_argnames=())
def fir_apply(state: FIRState, x: jax.Array, taps: jax.Array):
    """Streaming FIR step: filter block ``x`` [channels, n] with carry.

    Exactly equivalent to filtering the concatenated stream (overlap-save):
    chunked(fir_apply) == fir_filter(full stream). Returns (new_state, y).
    """
    taps = jnp.asarray(taps)
    xp = jnp.concatenate([state.tail.astype(x.dtype), x], axis=-1)
    y = _apply_windows(xp, taps)
    ntaps = taps.shape[0]
    new_tail = xp[:, -(ntaps - 1):] if ntaps > 1 else state.tail
    return FIRState(tail=new_tail), y
