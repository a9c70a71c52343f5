"""PFB channelizer tests (SURVEY.md §4 item 5: channelizer == per-channel
mixer+filter; and the wideband -> decode integration of §7 step 6)."""

import numpy as np
import pytest
import jax

import jax.numpy as jnp

from sondetpu.dsp.channelizer import (PFBChannelizer, _dft_axis0,
                                      _dft_axis_last, reference_channelize)


def _chan(pfb, state, iq):
    return pfb(state, np.ascontiguousarray(iq.real.astype(np.float32)),
               np.ascontiguousarray(iq.imag.astype(np.float32)))


def test_tone_lands_in_its_channel():
    n = 16
    fs_chan = 48000.0
    fs_wide = n * fs_chan
    pfb = PFBChannelizer(n)
    t = np.arange(int(fs_wide * 0.05)) / fs_wide
    for k in (0, 1, 5, n - 2):   # n-2 = -2 -> negative frequency
        f_center = pfb.center_freqs(fs_wide)[k]
        f = f_center + 1000.0      # 1 kHz offset inside the channel
        iq = np.exp(2j * np.pi * f * t).astype(np.complex64)
        st = pfb.init_state()
        st, yi, yq = _chan(pfb, st, iq)
        yi, yq = np.asarray(yi), np.asarray(yq)
        power = (yi ** 2 + yq ** 2).mean(axis=1)
        assert power.argmax() == k, (k, power.argmax())
        # offset tone appears at +1 kHz in the channel baseband
        y = (yi[k] + 1j * yq[k])[200:]
        phase_rate = np.angle(y[1:] * np.conj(y[:-1])).mean()
        f_meas = phase_rate / (2 * np.pi) * fs_chan
        assert f_meas == pytest.approx(1000.0, abs=20.0)


def test_chunked_equals_unchunked():
    n = 8
    pfb = PFBChannelizer(n)
    rng = np.random.default_rng(0)
    iq = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(np.complex64)
    st = pfb.init_state()
    _, yi_full, yq_full = _chan(pfb, st, iq)
    st = pfb.init_state()
    outs = []
    for i in range(0, 4096, 1024):
        st, yi, yq = _chan(pfb, st, iq[i:i + 1024])
        outs.append((np.asarray(yi), np.asarray(yq)))
    yi_c = np.concatenate([o[0] for o in outs], axis=1)
    yq_c = np.concatenate([o[1] for o in outs], axis=1)
    np.testing.assert_allclose(yi_c, np.asarray(yi_full), atol=1e-4)
    np.testing.assert_allclose(yq_c, np.asarray(yq_full), atol=1e-4)


def test_adjacent_channel_rejection():
    n = 16
    fs_wide = n * 48000.0
    pfb = PFBChannelizer(n)
    t = np.arange(int(fs_wide * 0.02)) / fs_wide
    f = pfb.center_freqs(fs_wide)[4]
    iq = np.exp(2j * np.pi * f * t).astype(np.complex64)
    st = pfb.init_state()
    _, yi, yq = _chan(pfb, st, iq)
    power = (np.asarray(yi) ** 2 + np.asarray(yq) ** 2).mean(axis=1)
    # neighbors at least 30 dB down
    assert power[4] / max(power[3], power[5]) > 1000


def test_wideband_to_rs41_decode():
    """The full stack: wideband IQ with an RS41 at a channel center ->
    channelize -> pipeline -> telemetry (replaces reference VFO chain,
    main.cpp:55-60)."""
    from sondetpu.runtime.pipeline import PipelineConfig
    from sondetpu.runtime.session import DecoderSession
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth

    n = 8
    fs_chan = 48000.0
    fs_wide = n * fs_chan
    pfb = PFBChannelizer(n)
    mod = RS41Modulator()
    iq_nb = mod.modulate([RS41Truth(frame_no=7 + i) for i in range(3)], fs=fs_chan)

    # place the sonde at channel 3's center: upsample by zero-stuffing is
    # wrong; instead synthesize at wideband rate directly
    bitsrc = mod.frames_to_bits(np.stack([mod.build_frame(RS41Truth(frame_no=7 + i))
                                          for i in range(3)]))
    from sondetpu.sondes.modulate import gfsk_modulate, freq_shift
    iq_wide = gfsk_modulate(bitsrc, fs_wide / 4800.0, 2400.0 / fs_wide, bt=0.5)
    f_center = pfb.center_freqs(fs_wide)[3]
    iq_wide = freq_shift(iq_wide, f_center / fs_wide)

    cfg = PipelineConfig(sonde="rs41", channels=n, block_len=48000)
    sess = DecoderSession(cfg)
    st = pfb.init_state()
    w = n * 48000
    pad = (-iq_wide.size) % w
    iq_wide = np.pad(iq_wide, (0, pad))
    for i in range(0, iq_wide.size - w + 1, w):
        st, yi, yq = _chan(pfb, st, iq_wide[i:i + w])
        sess.state, out = sess.pipeline.step(
            sess.state, (np.asarray(yi), np.asarray(yq)))
        sess._handle_output(out)
    assert 3 in sess.telemetry, sess.telemetry.keys()
    assert sess.telemetry[3].serial == "S1234567"
    assert sess.telemetry[3].lat == pytest.approx(45.0, abs=1e-4)


def test_factorized_dft_matches_direct():
    """The mixed-radix DFT (n > 64 path) equals the direct DFT matrix."""
    from sondetpu.dsp.channelizer import _dft_axis0

    rng = np.random.default_rng(1)
    for n in (96, 128, 256):   # composite sizes above the direct-path cap
        ui = rng.normal(size=(n, 7)).astype(np.float32)
        uq = rng.normal(size=(n, 7)).astype(np.float32)
        yi, yq = jax.jit(_dft_axis0)(ui, uq)
        # sign=+1 convention: y[k] = sum_p u[p] e^{+2pi i pk/n} == ifft(u)*n
        ref = np.fft.ifft((ui + 1j * uq).astype(np.complex64), axis=0) * n
        np.testing.assert_allclose(np.asarray(yi), ref.real, atol=2e-3)
        np.testing.assert_allclose(np.asarray(yq), ref.imag, atol=2e-3)


def test_large_pfb_tone_lands_in_its_channel():
    """A 128-channel PFB (factorized-DFT path) still routes tones."""
    n = 128
    fs_wide = n * 48000.0
    pfb = PFBChannelizer(n)
    t = np.arange(n * 2000) / fs_wide
    for k in (1, 37, n - 5):
        f = pfb.center_freqs(fs_wide)[k] + 1500.0
        iq = np.exp(2j * np.pi * f * t).astype(np.complex64)
        st = pfb.init_state()
        _, yi, yq = _chan(pfb, st, iq)
        power = (np.asarray(yi) ** 2 + np.asarray(yq) ** 2).mean(axis=1)
        assert power.argmax() == k, (k, power.argmax())


def _rel_rms(y, ref):
    return np.sqrt(np.mean(np.abs(y - ref) ** 2) / np.mean(np.abs(ref) ** 2))


# relative RMS error vs float64: the CPU computes float32 exactly (the
# card's TF32 bound lives in chip_smoke.py); bf16 stores every FIR/DFT
# stage in bf16 (2^-8 relative rounding per stage)
PFB_TOL = {"f32": 2e-6, "bf16": 1.5e-2}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048])
def test_pfb_matches_float64_reference(n, dtype):
    """The XLA PFB (slice-sum FIR + mixed-radix DFT) against the plain
    float64 NumPy channelizer, from a zero-history stream."""
    pfb = PFBChannelizer(n, dtype=dtype)
    rng = np.random.default_rng(n)
    x = rng.normal(size=n * 48) + 1j * rng.normal(size=n * 48)
    _, yi, yq = pfb(pfb.init_state(), x.real.astype(np.float32),
                    x.imag.astype(np.float32))
    y = np.asarray(yi, np.float64) + 1j * np.asarray(yq, np.float64)
    assert y.shape == (n, 48)
    assert _rel_rms(y, reference_channelize(pfb._hbank, x)) < PFB_TOL[dtype]


def test_pfb_carry_matches_reference_over_blocks():
    """Three blocks through the carried tail equal the reference over the
    whole stream (the tail is the reference's history)."""
    n, m = 128, 40
    pfb = PFBChannelizer(n)
    rng = np.random.default_rng(2)
    x = rng.normal(size=3 * n * m) + 1j * rng.normal(size=3 * n * m)
    ref = reference_channelize(pfb._hbank, x)
    st = pfb.init_state()
    got = []
    for b in range(3):
        blk = x[b * n * m:(b + 1) * n * m]
        st, yi, yq = pfb(st, blk.real.astype(np.float32),
                         blk.imag.astype(np.float32))
        got.append(np.asarray(yi, np.float64) + 1j * np.asarray(yq))
    assert _rel_rms(np.concatenate(got, axis=1), ref) < PFB_TOL["f32"]


def test_axis_last_dft_matches_axis0_with_sign_flip():
    """Feeding the branch-reversed (mod n) array to the axis-last DFT with
    the OPPOSITE sign must reproduce _dft_axis0's +j convention — the
    identity the channelizer's zero-cost permutation rests on."""
    rng = np.random.default_rng(7)
    for n in (16, 64, 256):
        u = rng.normal(size=(n, 40)).astype(np.float32)
        v = rng.normal(size=(n, 40)).astype(np.float32)
        ref_i, ref_q = _dft_axis0(jnp.asarray(u), jnp.asarray(v), sign=1.0)
        perm = np.zeros(n, np.int64)
        perm[1:] = n - np.arange(1, n)
        got_i, got_q = _dft_axis_last(jnp.asarray(u[perm].T),
                                      jnp.asarray(v[perm].T), sign=-1.0)
        np.testing.assert_allclose(np.asarray(got_i.T), np.asarray(ref_i),
                                   atol=2e-3)
        np.testing.assert_allclose(np.asarray(got_q.T), np.asarray(ref_q),
                                   atol=2e-3)
