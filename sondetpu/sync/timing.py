"""Symbol-timing recovery.

Two implementations of sondedump's Gardner interpolating PLL (SURVEY.md S0,
BASELINE.json:5 "Gardner symbol-timing recovery"):

1. :func:`oerder_meyr_tau` + :func:`symbol_sample` — the production path.
   Feed-forward square-law timing estimation (Oerder & Meyr 1988): the
   symbol-rate spectral line of ``x**2`` gives the timing phase for a whole
   block in one reduction, which vectorizes perfectly over channels and time
   — the idiomatic data-parallel answer to a feedback PLL. A per-channel
   NCO carry keeps the symbol grid continuous across blocks (slew-limited
   correction toward each block's estimate), so chunked processing tracks
   clock drift without dropping/duplicating symbols at block boundaries.

2. :func:`gardner_scan` — the classic data-dependent feedback loop as a
   ``lax.scan`` over time, vectorized across channels. Kept as the oracle
   for property tests and for signals too bursty for blockwise estimation.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class TimingState(NamedTuple):
    """Per-channel symbol-clock carry.

    pos: next symbol-center position relative to the start of the next block,
         in samples (fractional, in [0, sps)).
    locked: 0.0 until the first block sets the phase from its estimate.
    """

    pos: jax.Array     # [channels] float32
    locked: jax.Array  # [channels] float32 (0 or 1)


def timing_init(channels: int) -> TimingState:
    return TimingState(
        pos=jnp.zeros((channels,), jnp.float32),
        locked=jnp.zeros((channels,), jnp.float32),
    )


def oerder_meyr_tau(x: jax.Array, sps: float) -> jax.Array:
    """Feed-forward timing estimate per channel.

    x: [channels, n] real baseband (bipolar NRZ after demodulation).
    Returns tau [channels] in samples, in [0, sps): the offset of symbol
    centers from the block start.

    Square-law nonlinearity regenerates a spectral line at the symbol rate;
    its phase is the timing. tau = -T/(2*pi) * angle( sum |x|^2 e^{-j2*pi*n/sps} ).
    """
    n = x.shape[-1]
    idx = jnp.arange(n, dtype=jnp.float32)
    w = 2.0 * jnp.pi * idx / sps
    sq = x.astype(jnp.float32) ** 2
    # real-only form of sum(sq * exp(-j*w)): two real reductions that fuse
    # with the squaring
    cr = jnp.sum(sq * jnp.cos(w), axis=-1)
    ci = -jnp.sum(sq * jnp.sin(w), axis=-1)
    tau = -jnp.arctan2(ci, cr) / (2.0 * jnp.pi) * sps
    return jnp.mod(tau, sps)


def _linear_interp(x: jax.Array, pos: jax.Array) -> jax.Array:
    """Linearly interpolate x [channels, n] at fractional positions
    pos [channels, m]; out-of-range positions clamp to the edges."""
    n = x.shape[-1]
    p0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n - 2)
    frac = jnp.clip(pos - p0.astype(pos.dtype), 0.0, 1.0)
    a = jnp.take_along_axis(x, p0, axis=-1)
    b = jnp.take_along_axis(x, p0 + 1, axis=-1)
    return a + (b - a) * frac


def symbol_sample(state: TimingState, x: jax.Array, sps: float,
                  n_sym: int, slew: float = 0.5):
    """Sample symbol centers from block ``x`` [channels, n], continuing the
    per-channel symbol clock.

    Returns (new_state, soft [channels, n_sym], valid [channels, n_sym]).
    ``n_sym`` must be >= floor(n/sps)+1 (fixed capacity; invalid slots are
    masked). Each block the NCO phase is corrected toward the block's
    Oerder-Meyr estimate by at most ``slew`` samples (wrap-aware), tracking
    clock drift while never slipping a whole symbol within a locked stream.
    """
    n = x.shape[-1]
    tau = oerder_meyr_tau(x, sps)
    # wrap-aware error between the carried phase and the fresh estimate
    err = jnp.mod(tau - state.pos + sps / 2.0, sps) - sps / 2.0
    corrected = state.pos + jnp.clip(err, -slew, slew)
    start = jnp.where(state.locked > 0, corrected, tau)
    # CLAMP (not wrap) at the [0, sps) boundary: a slew that crosses zero
    # means the next center sits just before the block edge — wrapping by
    # +sps would SKIP that symbol and shift the chip stream by one, the
    # exact slip the slew limiter exists to prevent; the edge-clamping
    # interpolator handles a center pinned at the boundary gracefully.
    start = jnp.clip(start, 0.0, sps - 1e-3)

    k = jnp.arange(n_sym, dtype=jnp.float32)
    pos = start[:, None] + k[None, :] * sps          # [channels, n_sym]
    # A symbol anywhere inside [0, n) belongs to this block; one landing in
    # the final fractional interval (n-1, n) extrapolates from the last two
    # samples (interp clamps) — dropping it would slip the symbol clock.
    valid = pos < n
    soft = _linear_interp(x, pos)
    soft = jnp.where(valid, soft, 0.0)

    # next block's phase: first symbol position beyond this block
    n_fit = jnp.sum(valid, axis=-1).astype(jnp.float32)
    next_pos = start + n_fit * sps - n
    new_state = TimingState(pos=next_pos, locked=jnp.ones_like(state.locked))
    return new_state, soft, valid


@partial(jax.jit, static_argnames=("sps", "n_sym"))
def gardner_scan(x: jax.Array, sps: float, n_sym: int, gain: float = 0.02):
    """Classic Gardner timing-error-detector loop.

    Sequential scan over symbols (the feedback structure of sondedump's
    interpolating PLL, SURVEY.md S0), vectorized across channels: each scan
    step advances every channel by one symbol. Returns
    (soft [channels, n_sym], valid [channels, n_sym]).
    """
    c, n = x.shape

    def interp(pos):
        p0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n - 2)
        frac = pos - p0.astype(pos.dtype)
        a = jnp.take_along_axis(x, p0[:, None], axis=-1)[:, 0]
        b = jnp.take_along_axis(x, p0[:, None] + 1, axis=-1)[:, 0]
        return a + (b - a) * frac

    def step(carry, _):
        pos, prev = carry
        mid = interp(pos - sps / 2.0)
        cur = interp(pos)
        # Gardner TED: e = (cur - prev) * mid
        e = (cur - prev) * mid
        new_pos = pos + sps - jnp.clip(gain * e, -sps / 4, sps / 4)
        valid = pos <= (n - 1)
        return (new_pos, cur), (jnp.where(valid, cur, 0.0), valid)

    pos0 = jnp.full((c,), sps, dtype=jnp.float32)
    (_, _), (soft, valid) = jax.lax.scan(step, (pos0, jnp.zeros((c,), x.dtype)),
                                         None, length=n_sym)
    return soft.T, valid.T
