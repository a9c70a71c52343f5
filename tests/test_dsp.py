"""DSP kernel property tests (SURVEY.md §4 item 5)."""

import numpy as np
import pytest
import jax.numpy as jnp

from sondetpu.dsp import (
    FMState, design_lowpass, fir_apply, fir_filter, fir_init, fm_apply,
    fm_demod, fm_init, gaussian_taps, polyphase_decimate, rational_resample,
)
from sondetpu.dsp.resample import make_rational_resampler


def test_fir_matches_numpy_convolve():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 256)).astype(np.float32)
    taps = design_lowpass(0.2, 1.0, 31)
    y = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps)))
    for c in range(3):
        want = np.convolve(x[c], taps)[:256]
        np.testing.assert_allclose(y[c], want, atol=1e-5)


def test_fir_chunked_equals_unchunked():
    """Overlap-save carry: chunked == unchunked for any block size
    (SURVEY.md §7 'carry-over correctness')."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 600)).astype(np.float32)
    taps = jnp.asarray(design_lowpass(0.15, 1.0, 41))
    full = np.asarray(fir_filter(jnp.asarray(x), taps))
    for block in (50, 100, 150, 300):
        st = fir_init(2, 41)
        outs = []
        for i in range(0, 600, block):
            st, y = fir_apply(st, jnp.asarray(x[:, i:i + block]), taps)
            outs.append(np.asarray(y))
        np.testing.assert_allclose(np.concatenate(outs, axis=1), full, atol=1e-5)


def test_fir_complex():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 128)) + 1j * rng.normal(size=(2, 128))).astype(np.complex64)
    taps = design_lowpass(0.25, 1.0, 21)
    y = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps)))
    want = np.stack([np.convolve(x[c], taps)[:128] for c in range(2)])
    np.testing.assert_allclose(y, want, atol=1e-5)


def test_fm_demod_recovers_tone():
    """A tone at +deviation must demodulate to +1 (main.cpp:57 deviation
    convention)."""
    fs, dev = 48000.0, 2400.0
    n = 4800
    t = np.arange(n) / fs
    iq = np.exp(2j * np.pi * dev * t).astype(np.complex64)[None, :]
    audio = np.asarray(fm_demod(jnp.asarray(iq), fs, dev))
    np.testing.assert_allclose(audio[0, 10:], 1.0, atol=1e-3)


def test_fm_chunked_equals_unchunked():
    rng = np.random.default_rng(3)
    fs, dev = 48000.0, 2400.0
    phase = np.cumsum(rng.normal(size=1000)) * 0.1
    iq = np.exp(1j * phase).astype(np.complex64)[None, :]
    full = np.asarray(fm_demod(jnp.asarray(iq), fs, dev))
    st = fm_init(1)
    outs = []
    for i in range(0, 1000, 250):
        st, y = fm_apply(st, jnp.asarray(iq[:, i:i + 250]), fs, dev)
        outs.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(outs, axis=1), full, atol=1e-5)


def test_polyphase_decimate_tone():
    fs = 48000.0
    n = 4800
    t = np.arange(n) / fs
    x = np.cos(2 * np.pi * 1000.0 * t).astype(np.float32)[None, :]
    y = np.asarray(polyphase_decimate(jnp.asarray(x), 5, fs=fs))
    assert y.shape == (1, 960)
    # The decimated signal still contains the 1 kHz tone at the new rate
    spec = np.abs(np.fft.rfft(y[0, 100:900]))
    f = np.fft.rfftfreq(800, d=5 / fs)
    assert abs(f[np.argmax(spec)] - 1000.0) < 30


def test_rational_resample_tone():
    fs_in, fs_out = 20000.0, 48000.0
    up, down, taps = make_rational_resampler(fs_in, fs_out)
    assert (up, down) == (12, 5)
    n = 2000
    t = np.arange(n) / fs_in
    x = np.cos(2 * np.pi * 700.0 * t).astype(np.float32)[None, :]
    y = np.asarray(rational_resample(jnp.asarray(x), up, down, taps))
    assert y.shape[1] == n * up // down
    m = y.shape[1]
    # compare against an ideal resample in the steady-state region
    t_out = np.arange(m) / fs_out
    want = np.cos(2 * np.pi * 700.0 * t_out)
    # allow for filter group delay: correlate to find it
    core = y[0, 200:m - 200]
    lag = np.argmax(np.correlate(want, core, mode="valid"))
    np.testing.assert_allclose(core, want[lag:lag + core.size], atol=0.05)


def test_streaming_resampler_chunked_equals_stateless():
    from sondetpu.dsp.resample import StreamingResampler, make_rational_resampler

    fs_in, fs_out = 20000.0, 48000.0
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 4000)).astype(np.float32)
    up, down, taps = make_rational_resampler(fs_in, fs_out)
    full = np.asarray(rational_resample(jnp.asarray(x), up, down, taps))

    rs = StreamingResampler(fs_in, fs_out, channels=2)
    outs = [rs.process(x[:, i:i + 500]) for i in range(0, 4000, 500)]
    y = np.concatenate(outs, axis=1)
    m = min(y.shape[1], full.shape[1])
    np.testing.assert_allclose(y[:, :m], full[:, :m], atol=1e-4)


def test_c64_to_planes_native():
    from sondetpu.io.iq import c64_to_planes

    rng = np.random.default_rng(8)
    iq = (rng.normal(size=(3, 100)) + 1j * rng.normal(size=(3, 100))).astype(np.complex64)
    i, q = c64_to_planes(iq)
    np.testing.assert_array_equal(i, iq.real)
    np.testing.assert_array_equal(q, iq.imag)
    assert i.flags["C_CONTIGUOUS"] and i.dtype == np.float32


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("channels", [5, 300, 520])
def test_grouped_conv_matches_numpy(channels, stride):
    """The batched grouped conv behind every FIR (_apply_windows) against
    np.convolve, across the feature-group splits (one row; N = 8 rows;
    power-of-two fallback) and with fused decimation."""
    from sondetpu.dsp.fir import _apply_windows, _group_size

    rng = np.random.default_rng(channels + stride)
    n, ntaps = 1200, 41
    x = rng.normal(size=(channels, n + ntaps - 1)).astype(np.float32)
    taps = design_lowpass(5000.0, 48000.0, ntaps)
    y = np.asarray(_apply_windows(jnp.asarray(x), jnp.asarray(taps),
                                  stride=stride))
    want = np.stack([np.convolve(r.astype(np.float64), taps)
                     [ntaps - 1:ntaps - 1 + n:stride] for r in x])
    assert y.shape == want.shape
    assert _group_size(channels) == {5: 5, 300: 4, 520: 65}[channels]
    np.testing.assert_allclose(y, want, atol=2e-5)


def _fm_frontend_numpy(x, chan, match, decim, scale):
    """Float64 chanfilt (stride decim) -> FM discriminator -> DC block ->
    matched FIR, zero initial state."""
    n = x.shape[-1]
    cf = np.stack([np.convolve(r, chan)[:n:decim] for r in x])
    prev = np.concatenate([np.zeros((x.shape[0], 1)), cf[:, :-1]], axis=1)
    audio = np.angle(cf * np.conj(prev)) * scale
    audio -= audio.mean(axis=1, keepdims=True)
    return np.stack([np.convolve(r, match)[:audio.shape[1]] for r in audio])


@pytest.mark.parametrize("decim,n", [(1, 4800), (2, 4800), (1, 4797)])
def test_fm_frontend_matches_numpy(decim, n):
    """The jnp demod front end (parallel/sharding.frontend_serial, the
    pipeline's chanfilt -> discriminator -> DC -> matched FIR chain)
    against float64 NumPy, at full and half rate and on a block length
    that is no multiple of anything."""
    from sondetpu.parallel.sharding import frontend_serial

    rng = np.random.default_rng(decim * n)
    fs, dev = 48000.0, 2400.0
    bits = np.repeat(rng.choice([-1.0, 1.0], size=n // 10 + 1), 10)[:n]
    ph = 2 * np.pi * dev / fs * np.cumsum(bits)
    x = np.exp(1j * ph)[None, :] + 0.05 * (rng.normal(size=(3, n))
                                          + 1j * rng.normal(size=(3, n)))
    chan = design_lowpass(5000.0, fs, 41)
    match = design_lowpass(2640.0, fs / decim, 41)
    scale = fs / decim / (2 * np.pi * dev)
    got = np.asarray(frontend_serial(
        jnp.asarray(x.real, jnp.float32), jnp.asarray(x.imag, jnp.float32),
        chan, match, decim=decim, scale=scale))
    want = _fm_frontend_numpy(x, chan.astype(np.float64),
                              match.astype(np.float64), decim, scale)
    assert got.shape == want.shape == (3, -(-n // decim))
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("sonde", ["imet4", "c50"])
def test_afsk_frontend_matches_numpy(sonde):
    """The pipeline's jnp AFSK tone discriminator (mark/space mix,
    one-symbol boxcar, normalized envelope difference) against float64
    NumPy over two blocks, through the carried tone-filter tails and LO
    phase."""
    import jax
    from sondetpu.runtime.pipeline import Pipeline, PipelineConfig

    p = Pipeline(PipelineConfig(sonde=sonde, channels=2, block_len=48000))
    spec, fs, win = p.config.spec, p.config.fs, p._afsk_win
    rng = np.random.default_rng(3)
    t = np.arange(96000)
    tone = np.where(np.repeat(rng.integers(0, 2, 96000 // win + 1),
                              win)[:96000] > 0, spec.afsk_mark,
                    spec.afsk_space)
    audio = np.sin(2 * np.pi * np.cumsum(tone) / fs)[None, :] \
        + 0.1 * rng.normal(size=(2, 96000))
    box = np.ones(win) / win
    en = []
    for f in (spec.afsk_mark, spec.afsk_space):
        w = 2 * np.pi * f / fs
        fi = np.stack([np.convolve(r, box)[:96000] for r in audio * np.cos(w * t)])
        fq = np.stack([np.convolve(r, box)[:96000] for r in audio * np.sin(w * t)])
        en.append(fi ** 2 + fq ** 2)
    want = (en[0] - en[1]) / (en[0] + en[1] + 1e-9)
    st = p.init_state()
    fn = jax.jit(p._afsk_frontend)
    for b in range(2):
        blk = jnp.asarray(audio[:, b * 48000:(b + 1) * 48000], jnp.float32)
        soft, _, aux = fn(st, blk)
        st = st._replace(aux=aux)
        np.testing.assert_allclose(np.asarray(soft),
                                   want[:, b * 48000:(b + 1) * 48000],
                                   atol=2e-3)
