"""Analog demodulators: FM quadrature discriminator, AFSK tone discriminator.

Accelerator-native equivalent of SDR++'s ``dsp::demod::FM`` (consumed at reference
src/main.cpp:57 with deviation = bandwidth/2) and of sondedump's AFSK front
end for iMet-4/SRS-C50 (SURVEY.md S5/S6). Batched over a channel axis; the
one-sample carry across blocks makes chunked demodulation exactly equal to
demodulating the unchunked stream.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sondetpu.dsp.fir import fir_filter


class FMState(NamedTuple):
    """Per-channel carry: the previous complex sample."""

    prev: jax.Array  # [channels] complex64


def fm_init(channels: int) -> FMState:
    return FMState(prev=jnp.zeros((channels,), dtype=jnp.complex64))


def fm_demod(iq: jax.Array, fs: float, deviation: float) -> jax.Array:
    """Stateless quadrature FM discriminator, zero initial phase reference.

    iq: [channels, n] complex64. Output normalized so a tone at +deviation
    reads +1.0 (matching the reference chain where FM deviation is set to
    half the channel bandwidth, main.cpp:57).
    """
    prev = jnp.concatenate([jnp.zeros((iq.shape[0], 1), iq.dtype), iq[:, :-1]], axis=-1)
    return _discriminate(iq, prev, fs, deviation)


def _discriminate(iq, prev, fs, deviation):
    # angle(x[n] * conj(x[n-1])) * fs / (2*pi*deviation)
    d = iq * jnp.conj(prev)
    return jnp.arctan2(d.imag, d.real) * (fs / (2.0 * jnp.pi * deviation))


def fm_apply(state: FMState, iq: jax.Array, fs: float, deviation: float):
    """Streaming FM discriminator step. Returns (new_state, audio)."""
    prev = jnp.concatenate([state.prev[:, None], iq[:, :-1]], axis=-1)
    audio = _discriminate(iq, prev, fs, deviation)
    return FMState(prev=iq[:, -1]), audio


def afsk_discriminate(audio: jax.Array, fs: float, f_mark: float, f_space: float,
                      baud: float) -> jax.Array:
    """Dual-tone AFSK discriminator: +1 toward mark, -1 toward space.

    Quadrature correlators at the mark and space tones with an
    integrate-and-dump window of one symbol; the difference of envelope
    energies is the soft bit stream (sampled by the timing-recovery stage).
    audio: [channels, n] float32 (FM-demodulated audio for iMet-4/C50,
    SURVEY.md S5: "dual-tone Goertzel/quadrature discriminator kernel").
    """
    n = audio.shape[-1]
    t = jnp.arange(n, dtype=jnp.float32) / fs
    win = max(int(fs / baud), 1)
    box = jnp.ones(win, dtype=jnp.float32) / win

    def tone_energy(f):
        # real LO planes (framework convention: I/Q planes rather than
        # complex64; cos/-sin mixing is mathematically identical)
        w = 2.0 * jnp.pi * f
        ci = audio * jnp.cos(w * t)
        cq = -audio * jnp.sin(w * t)
        # integrate-and-dump via boxcar FIR on I and Q
        i = fir_filter(ci, box)
        q = fir_filter(cq, box)
        return i * i + q * q

    return tone_energy(f_mark) - tone_energy(f_space)
