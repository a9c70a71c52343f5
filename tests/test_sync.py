"""Timing recovery, correlator, and line-coding tests."""

import numpy as np
import pytest
import jax.numpy as jnp

from sondetpu.sync import (
    bits_to_bytes, bytes_to_bits, biphase_m_decode, correlate_syncword,
    descramble_xor, find_frame_starts, gather_frames, gardner_scan,
    manchester_decode, oerder_meyr_tau, symbol_sample, syncword_to_chips,
    timing_init,
)
from sondetpu.sync.coding import np_bits_to_bytes, np_bytes_to_bits


def _nrz_signal(bits, sps, tau=0.0, n=None, filt=True):
    """NRZ at sps samples/symbol, matched-filtered (triangular eye) so the
    square-law timing estimator has a spectral line — mirrors the pipeline,
    where timing always runs after the matched filter."""
    sym = bits.astype(np.float32) * 2 - 1
    x = np.repeat(sym, sps)
    if filt:
        h = np.ones(sps, dtype=np.float32) / sps
        x = np.convolve(x, h)[: x.size]
    if tau:
        # fractional delay by linear interpolation
        idx = np.arange(x.size - 1)
        x = x[idx] * (1 - tau) + x[idx + 1] * tau
    if n is not None:
        x = x[:n]
    return x


def test_oerder_meyr_estimates_offset():
    """Shifting the signal by s samples shifts the tau estimate by -s."""
    rng = np.random.default_rng(0)
    sps = 10
    bits = rng.integers(0, 2, size=600)
    x_full = _nrz_signal(bits, sps)
    tau0 = float(oerder_meyr_tau(jnp.asarray(x_full[:4000][None, :]), sps)[0])
    for shift in (3, 7):
        x = x_full[shift:shift + 4000][None, :]
        tau = float(oerder_meyr_tau(jnp.asarray(x), sps)[0])
        expect = (tau0 - shift) % sps
        err = (tau - expect + sps / 2) % sps - sps / 2
        assert abs(err) < 0.5, (shift, tau, expect)
    # absolute phase: the eye is widest at symbol centers; for the
    # boxcar-matched NRZ the peak sits at the end-of-integration instant
    centers = (np.arange(20) * sps + tau0).astype(int)
    vals = np.abs(x_full[centers])
    assert vals.mean() > 0.8 * np.abs(x_full).max()


def test_symbol_sample_recovers_bits_chunked():
    rng = np.random.default_rng(1)
    sps = 10
    bits = rng.integers(0, 2, size=1200)
    x = _nrz_signal(bits, sps)
    x = x + rng.normal(scale=0.1, size=x.size).astype(np.float32)
    x = x[None, :].astype(np.float32)
    n = x.shape[1]
    block = 3000
    st = timing_init(1)
    got = []
    n_sym_cap = block // sps + 2
    for i in range(0, n - block + 1, block):
        st, soft, valid = symbol_sample(st, jnp.asarray(x[:, i:i + block]), sps, n_sym_cap)
        v = np.asarray(valid[0])
        got.append(np.asarray(soft[0])[v])
    sliced = (np.concatenate(got) > 0).astype(np.uint8)
    # find alignment of decoded bits inside the sent bits and compare
    sent = bits.astype(np.uint8)
    best = 0
    for lag in range(4):
        m = min(sliced.size - lag, sent.size)
        acc = (sliced[lag:lag + m] == sent[:m]).mean()
        best = max(best, acc)
    assert best > 0.995, best


def test_gardner_scan_recovers_bits():
    rng = np.random.default_rng(2)
    sps = 10
    bits = rng.integers(0, 2, size=500)
    x = _nrz_signal(bits, sps, tau=0.3)[None, :].astype(np.float32)
    soft, valid = gardner_scan(jnp.asarray(x), float(sps), 480)
    sliced = (np.asarray(soft[0]) > 0).astype(np.uint8)
    sent = bits.astype(np.uint8)
    accs = []
    for lag in range(3):
        m = min(sliced.size, sent.size - lag)
        accs.append((sliced[:m] == sent[lag:lag + m]).mean())
    assert max(accs) > 0.98, accs


def test_correlator_finds_syncword():
    rng = np.random.default_rng(3)
    sync = bytes([0x10, 0xB6, 0xCA, 0x11])
    tmpl = syncword_to_chips(sync)
    # two channels, known insert positions
    n = 2000
    soft = rng.choice([-1.0, 1.0], size=(2, n)).astype(np.float32)
    pos = [100, 1500]
    for c, p in enumerate([(100, 1500), (700,)]):
        for q in p:
            soft[c, q:q + 32] = tmpl
    corr = correlate_syncword(jnp.asarray(soft), jnp.asarray(tmpl))
    starts, ok = find_frame_starts(corr, threshold=0.9, max_peaks=4, min_distance=50)
    s0 = sorted(np.asarray(starts[0])[np.asarray(ok[0])].tolist())
    s1 = np.asarray(starts[1])[np.asarray(ok[1])].tolist()
    assert s0 == [100, 1500]
    assert s1 == [700]
    # gather frames of 40 chips at those offsets
    frames, valid = gather_frames(jnp.asarray(soft), starts, ok, 40)
    assert bool(valid[0, 0])
    np.testing.assert_allclose(np.asarray(frames[0, 0])[:32], tmpl)


def test_correlator_noise_robustness():
    rng = np.random.default_rng(4)
    sync = bytes([0x9A, 0x99, 0x5A, 0x55, 0x10, 0xB6, 0xCA, 0x11])
    tmpl = syncword_to_chips(sync)
    soft = rng.choice([-1.0, 1.0], size=(1, 4000)).astype(np.float32)
    soft[0, 2000:2064] = tmpl
    noisy = soft + rng.normal(scale=0.7, size=soft.shape).astype(np.float32)
    corr = correlate_syncword(jnp.asarray(noisy), jnp.asarray(tmpl))
    starts, ok = find_frame_starts(corr, threshold=0.55, max_peaks=2, min_distance=100)
    found = np.asarray(starts)[np.asarray(ok)].tolist()
    assert 2000 in found


def test_bit_byte_roundtrip():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(3, 17), dtype=np.uint8)
    for lsb in (False, True):
        bits = bytes_to_bits(jnp.asarray(data), lsb_first=lsb)
        back = np.asarray(bits_to_bytes(bits, lsb_first=lsb))
        np.testing.assert_array_equal(back, data)
        npbits = np_bytes_to_bits(data, lsb_first=lsb)
        np.testing.assert_array_equal(np.asarray(bits), npbits)
        np.testing.assert_array_equal(np_bits_to_bytes(npbits, lsb_first=lsb), data)


def test_manchester_and_biphase():
    bits = np.array([1, 0, 1, 1, 0], dtype=np.uint8)
    # IEEE Manchester encode: 1 -> (1,0), 0 -> (0,1)
    chips = np.zeros(10, dtype=np.uint8)
    chips[0::2] = bits
    chips[1::2] = 1 - bits
    got = np.asarray(manchester_decode(jnp.asarray(chips[None, :])))[0]
    np.testing.assert_array_equal(got, bits)

    # biphase-mark: mid-cell transition == 1
    chips = []
    level = 0
    for b in bits:
        level ^= 1               # cell-start transition always
        first = level
        if b:
            level ^= 1           # mid-cell transition encodes 1
        chips += [first, level]
    got = np.asarray(biphase_m_decode(jnp.asarray(np.array(chips, np.uint8)[None, :])))[0]
    np.testing.assert_array_equal(got, bits)


def test_descramble_roundtrip():
    rng = np.random.default_rng(6)
    mask = rng.integers(0, 256, size=64, dtype=np.uint8)
    data = rng.integers(0, 256, size=(2, 320), dtype=np.uint8)
    scrambled = np.asarray(descramble_xor(jnp.asarray(data), mask))
    back = np.asarray(descramble_xor(jnp.asarray(scrambled), mask))
    np.testing.assert_array_equal(back, data)
    assert not np.array_equal(scrambled, data)


def test_gather_frames_block_shorter_than_frame():
    """A stream shorter than one frame returns empty/invalid instead of a
    trace-time lax.gather error (slice_sizes > operand dim)."""
    import jax.numpy as jnp

    from sondetpu.sync.correlator import gather_frames

    stream = jnp.zeros((2, 10), jnp.float32)
    starts = jnp.zeros((2, 3), jnp.int32)
    ok = jnp.ones((2, 3), bool)
    frames, valid = gather_frames(stream, starts, ok, 64)
    assert frames.shape == (2, 3, 64)
    assert not bool(valid.any())


@pytest.mark.parametrize("length,dtype", [(64, "float32"), (48, "bfloat16")])
def test_correlate_syncword_matches_np_correlate(length, dtype):
    """correlate_syncword (the grouped conv, normalized by the template
    length) equals np.correlate in 'valid' mode row by row."""
    import jax.numpy as jnp

    rng = np.random.default_rng(length)
    soft = rng.normal(size=(6, 700)).astype(np.float32)
    tmpl = rng.choice([-1.0, 1.0], size=length).astype(np.float32)
    x = jnp.asarray(soft, dtype)
    got = np.asarray(correlate_syncword(x, tmpl))
    xs = np.asarray(x.astype(jnp.float32), np.float64)
    want = np.stack([np.correlate(r, tmpl, "valid") for r in xs]) / length
    assert got.shape == want.shape == (6, 700 - length + 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
