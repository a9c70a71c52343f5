"""Polyphase filter-bank channelizer: wideband IQ -> N baseband channels.

The accelerator replacement for SDR++'s per-sonde VFO channel extraction
(SURVEY.md C5: "wideband IQ -> thousands of narrowband channels in one
batched kernel"): where the reference creates one mixer+decimator VFO per
module instance (main.cpp:55-56), this computes ALL channels at once with a
critically-sampled DFT filter bank:

    u_p[m]   = sum_j h[jN+p] * x[(m-j)N - p]        (polyphase branches)
    y_k[m]   = sum_p u_p[m] * exp(-2j*pi*k*p/N)      (DFT across branches)

Everything runs on real I/Q planes; the DFT across branches is a
mixed-radix chain of real matmuls (einsums at the default matmul precision:
TF32 for float32 operands on a GPU that has it, bf16 for bf16 fleets, with
float32 accumulation). Channel k is
centered at k * fs_chan (k interpreted mod N, negative above N/2) — the
channel-grid analogue of the reference's 1 kHz VFO snap (main.cpp:56);
residual per-channel offsets are absorbed downstream by the FM demod's DC
block (runtime/pipeline.py).

Streaming: a tail of N*taps_per_phase wideband samples carries across
blocks, so chunked channelization equals unchunked exactly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from sondetpu.dsp.fir import design_lowpass


class ChannelizerState(NamedTuple):
    tail_i: jax.Array    # [L] last wideband I samples
    tail_q: jax.Array    # [L] last wideband Q samples


def _largest_factor(n: int, cap: int = 64):
    """Largest divisor of n that is <= cap (None if n is prime or <= cap)."""
    best = None
    for f in range(2, min(n, cap + 1)):
        if n % f == 0:
            best = f
    return best


def _dft_axis0(ui: jax.Array, uq: jax.Array, sign: float = 1.0):
    """Complex DFT over axis 0 on (I, Q) planes: y[k] = sum_p u[p] e^{sign*2pi*i*pk/n}.

    Mixed-radix Cooley-Tukey: the DFT is factorized into matmul stages with
    factors <= 64 so each stage costs O(f) MACs per sample
    instead of the O(n) of a direct DFT matrix (at N = 2048 = 64 x 32, 96
    instead of 2048 complex MACs per output, plus a twiddle). Falls back
    to the direct matrix for small or prime n.
    """
    n = ui.shape[0]
    f = _largest_factor(n)
    if n <= 64 or f is None:
        p = np.arange(n)
        ang = sign * 2.0 * np.pi * np.outer(p, p) / n
        c = jnp.asarray(np.cos(ang), jnp.float32)
        s = jnp.asarray(np.sin(ang), jnp.float32)
        yi = jnp.einsum("pk,p...->k...", c, ui) - jnp.einsum("pk,p...->k...", s, uq)
        yq = jnp.einsum("pk,p...->k...", c, uq) + jnp.einsum("pk,p...->k...", s, ui)
        return yi, yq
    n1 = f                      # outer (direct) stage size
    n2 = n // n1                # inner (recursive) stage size
    tail = ui.shape[1:]
    # u[p1 + n1*p2] -> u_r[p2, p1]; inner DFT_{n2} over p2 for every p1
    u_ri = ui.reshape((n2, n1) + tail)
    u_rq = uq.reshape((n2, n1) + tail)
    ai, aq = _dft_axis0(u_ri, u_rq, sign)          # [k2, p1, ...]
    # twiddle W_n^{sign * p1*k2}
    k2 = np.arange(n2)
    p1 = np.arange(n1)
    ang = sign * 2.0 * np.pi * np.outer(k2, p1) / n
    shape = (n2, n1) + (1,) * len(tail)
    tc = jnp.asarray(np.cos(ang).reshape(shape), jnp.float32)
    ts = jnp.asarray(np.sin(ang).reshape(shape), jnp.float32)
    ti = ai * tc - aq * ts
    tq = aq * tc + ai * ts
    # outer DFT_{n1} over p1: y[k1*n2 + k2] = sum_{p1} T[k2, p1] W_{n1}^{p1 k1}
    ang1 = sign * 2.0 * np.pi * np.outer(p1, p1) / n1
    c1 = jnp.asarray(np.cos(ang1), jnp.float32)
    s1 = jnp.asarray(np.sin(ang1), jnp.float32)
    yi = (jnp.einsum("pd,kp...->dk...", c1, ti)
          - jnp.einsum("pd,kp...->dk...", s1, tq))
    yq = (jnp.einsum("pd,kp...->dk...", c1, tq)
          + jnp.einsum("pd,kp...->dk...", s1, ti))
    return yi.reshape((n,) + tail), yq.reshape((n,) + tail)


def _dft_axis_last(ui: jax.Array, uq: jax.Array, sign: float = 1.0):
    """Complex DFT over the LAST axis on (I, Q) planes:
    y[..., k] = sum_p u[..., p] e^{sign*2pi*i*pk/n}.

    The time-major twin of :func:`_dft_axis0` (same mixed-radix Cooley-
    Tukey factorization, factors <= 64 so every stage is a small matmul)
    for [time, branch] activations — the layout the PFB's FIR produces.
    Contracting the last axis keeps the big time dimension as matmul rows.
    """
    n = ui.shape[-1]
    f = _largest_factor(n)
    dt = ui.dtype          # bf16 stages halve the DFT's HBM traffic; the
                           # matmuls still accumulate f32
    if n <= 64 or f is None:
        k = np.arange(n)
        ang = sign * 2.0 * np.pi * np.outer(k, k) / n
        c = jnp.asarray(np.cos(ang), dt)
        s = jnp.asarray(np.sin(ang), dt)
        return ui @ c - uq @ s, uq @ c + ui @ s
    n1 = f
    n2 = n // n1
    lead = ui.shape[:-1]
    # u[..., p1 + n1*p2] -> [..., p1, p2]; inner DFT_{n2} over p2
    u_ri = ui.reshape(lead + (n2, n1)).swapaxes(-1, -2)
    u_rq = uq.reshape(lead + (n2, n1)).swapaxes(-1, -2)
    ai, aq = _dft_axis_last(u_ri, u_rq, sign)          # [..., p1, k2]
    k2 = np.arange(n2)
    p1 = np.arange(n1)
    ang = sign * 2.0 * np.pi * np.outer(p1, k2) / n
    tc = jnp.asarray(np.cos(ang), dt)
    ts_ = jnp.asarray(np.sin(ang), dt)
    ti = ai * tc - aq * ts_
    tq = aq * tc + ai * ts_
    # outer DFT_{n1} over p1 (axis -2): y[..., k1, k2]
    ang1 = sign * 2.0 * np.pi * np.outer(p1, p1) / n1
    c1 = jnp.asarray(np.cos(ang1), dt)
    s1 = jnp.asarray(np.sin(ang1), dt)
    yi = (jnp.einsum("...pk,pd->...dk", ti, c1)
          - jnp.einsum("...pk,pd->...dk", tq, s1))
    yq = (jnp.einsum("...pk,pd->...dk", tq, c1)
          + jnp.einsum("...pk,pd->...dk", ti, s1))
    return yi.reshape(lead + (n,)), yq.reshape(lead + (n,))


def reference_channelize(hbank: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Plain float64 NumPy channelizer: the oracle the PFB is checked
    against. hbank [N, tpp] is the filter bank's prototype (hbank[q, p] =
    h[p*N + q]); x [W] complex is one block from a zero-history stream.
    Returns y [N, W/N] complex128 with channel k down-converted by its
    center, filtered by h and decimated by N:

        y_k[m] = sum_l h[l] x[mN - l] e^{-2 pi i k (mN - l) / N}
    """
    n, tpp = hbank.shape
    x = np.asarray(x, np.complex128)
    m_out = x.size // n
    xp = np.concatenate([np.zeros(n * tpp, np.complex128), x])
    m = np.arange(m_out)[:, None, None]
    q = np.arange(n)[None, :, None]
    p = np.arange(tpp)[None, None, :]
    win = xp[(m - p) * n - q + n * tpp]                 # [m, q, p]
    u = np.einsum("mqp,qp->mq", win, np.asarray(hbank, np.float64))
    return (n * np.fft.ifft(u, axis=1)).T


def bin_and_offset(center_hz: float, fs_chan: float, n_bins: int):
    """Map an arbitrary carrier frequency to (pfb_bin, fine_offset_hz).

    The inverse of :meth:`PFBChannelizer.center_freqs` for off-grid
    carriers: the nearest bin (mod N — the Nyquist bin aliases like any
    other) plus the ALIAS-EQUIVALENT residual in [-fs_chan/2, fs_chan/2],
    so the downstream fine DDC always rotates by a small frequency (a
    large unwrapped residual would hit float32 phase quantization)."""
    r = round(center_hz / fs_chan)
    return int(r) % n_bins, center_hz - r * fs_chan


class PFBChannelizer:
    """Critically-sampled N-channel analysis filter bank.

    ``dtype="bf16"`` stores the branch-FIR outputs and DFT stages in
    bfloat16 (matmul accumulation stays f32): the PFB reads and writes
    the whole wideband block, so halving its traffic is the largest
    lever on its memory cost. bf16's ~0.4%/stage quantization sits ~40 dB under the channel
    noise at any decodable SNR (decode-parity asserted in
    tests/test_fleet.py)."""

    def __init__(self, n_channels: int, taps_per_phase: int = 8,
                 cutoff_frac: float = 0.45, dtype: str = "f32"):
        if dtype not in ("f32", "bf16"):
            raise ValueError(dtype)
        self.dtype = dtype
        self.n = int(n_channels)
        self.tpp = int(taps_per_phase)
        L = self.n * self.tpp
        # prototype lowpass at the channel Nyquist, unity passband
        proto = design_lowpass(cutoff_frac, float(self.n), L + 1)[:L] * self.n
        self._hbank = proto.reshape(self.tpp, self.n).T.astype(np.float32)  # [N, tpp]
        # column taps for the time-major FIR: column j of the reshaped
        # block holds branch p = (N - j) % N (see _impl)
        perm = np.zeros(self.n, np.int64)
        perm[1:] = self.n - np.arange(1, self.n)
        self._hcol = np.ascontiguousarray(self._hbank[perm].T)  # [tpp, N]

    @property
    def history(self) -> int:
        return self.n * self.tpp

    def init_state(self) -> ChannelizerState:
        return ChannelizerState(tail_i=np.zeros(self.history, np.float32),
                                tail_q=np.zeros(self.history, np.float32))

    def center_freqs(self, fs_wide: float) -> np.ndarray:
        """Center frequency of each output channel (Hz, negative above N/2)."""
        k = np.arange(self.n)
        k = np.where(k < self.n / 2, k, k - self.n)
        return k * fs_wide / self.n

    def bin_and_offset(self, center_hz: float, fs_chan: float):
        """Map an arbitrary carrier frequency to (pfb_bin, fine_offset_hz);
        see :func:`bin_and_offset`."""
        return bin_and_offset(center_hz, fs_chan, self.n)

    def __call__(self, state: ChannelizerState, x_i: jax.Array, x_q: jax.Array):
        """One block: wideband planes [W] (W % N == 0) ->
        (state, y_i [N, W/N], y_q [N, W/N]). Jit-compiled; results are
        device-resident. The compiled program is cached MODULE-wide keyed
        on (n, tpp) + shapes, so code that constructs fresh channelizers
        per use (scan probes, AutoFleet rebuilds) does not re-trace."""
        return _pfb_jit(self.n, self.tpp, self.dtype, jnp.asarray(self._hcol),
                        state, x_i, x_q)

    def _impl(self, state: ChannelizerState, x_i: jax.Array, x_q: jax.Array):
        """Time-major polyphase step.

        The block reshapes to vv[r, j] = xp[r*N + j] (free); column j of vv
        holds the window samples of branch p = (N - j) % N, branch 0 one
        row later — so the branch FIR runs WITHOUT any transpose, flip or
        gather, as tpp shifted-row multiply-adds. The column permutation
        is index reversal mod N, which the DFT absorbs for free by
        flipping its sign:
            sum_j u_t[j] e^{-2pi i jk/N} = sum_p u[p] e^{+2pi i pk/N}
        so channel k keeps the +j convention (a tone at +k*fs_chan lands
        in output channel k) with zero repermutation cost.
        """
        n, tpp = self.n, self.tpp
        L = self.history
        m_out = x_i.shape[-1] // n

        cdt = jnp.bfloat16 if self.dtype == "bf16" else jnp.float32
        xp_i = jnp.concatenate([jnp.asarray(state.tail_i), x_i])  # [L + W]
        xp_q = jnp.concatenate([jnp.asarray(state.tail_q), x_q])
        vv_i = xp_i.reshape(-1, n).astype(cdt)          # [tpp + m_out, N]
        vv_q = xp_q.reshape(-1, n).astype(cdt)
        # col-0 row shift + sum of tpp shifted row slices
        rows = m_out + tpp - 1
        hcol = jnp.asarray(self._hcol, cdt)

        def fir_tm(vv):
            vvs = jnp.concatenate([vv[1:rows + 1, :1], vv[:rows, 1:]], axis=1)
            acc = None
            for t in range(tpp):
                o = tpp - 1 - t
                s = vvs[o:o + m_out, :] * hcol[t][None, :]
                acc = s if acc is None else acc + s
            return acc

        u_i = fir_tm(vv_i)
        u_q = fir_tm(vv_q)
        # materialization fence: without it XLA fuses the FIR into every
        # DFT einsum and recomputes it once per consumer
        u_i, u_q = jax.lax.optimization_barrier((u_i, u_q))
        new_state = ChannelizerState(tail_i=xp_i[-L:], tail_q=xp_q[-L:])
        # DFT across branches; sign=-1 + the column permutation == the +j
        # convention
        y_i, y_q = _dft_axis_last(u_i, u_q, sign=-1.0)
        return new_state, y_i.T, y_q.T


@partial(jax.jit, static_argnums=(0, 1, 2))
def _pfb_jit(n: int, tpp: int, dtype: str, hcol: jax.Array,
             state: ChannelizerState, x_i: jax.Array, x_q: jax.Array):
    """Module-level compiled PFB step: one cache entry per
    (n, tpp, dtype, shapes) shared by every PFBChannelizer instance."""
    shell = PFBChannelizer.__new__(PFBChannelizer)
    shell.n, shell.tpp = n, tpp
    shell._hcol = hcol
    shell.dtype = dtype
    return shell._impl(state, x_i, x_q)
