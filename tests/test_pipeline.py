"""End-to-end pipeline tests: modulated RS41 IQ -> decoded telemetry.

The minimum end-to-end slice of SURVEY.md §7 step 4, as a golden-IQ test:
synthesized frames with known truth must decode bit-exactly through the
full batched device chain.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from sondetpu.runtime.pipeline import Pipeline, PipelineConfig
from sondetpu.runtime.session import DecoderSession
from sondetpu.sondes.modulate import add_awgn, freq_shift
from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth
from sondetpu.telemetry import Fields


def _make_iq(n_frames=6, channels=1, snr_db=None, seed=0, **truth_kw):
    mod = RS41Modulator()
    truths = [RS41Truth(frame_no=100 + i, **truth_kw) for i in range(n_frames)]
    iq = mod.modulate(truths, fs=48000.0)
    rng = np.random.default_rng(seed)
    chans = []
    for c in range(channels):
        x = iq.copy()
        if snr_db is not None:
            x = add_awgn(x, snr_db, rng=rng)
        chans.append(x)
    return np.stack(chans), truths


def test_rs41_end_to_end_clean():
    iq, truths = _make_iq(n_frames=6)
    cfg = PipelineConfig(sonde="rs41", channels=1, block_len=48000)
    sess = DecoderSession(cfg)
    updates = []
    n = iq.shape[1]
    for i in range(0, n - cfg.block_len + 1, cfg.block_len):
        updates += sess.process_block(iq[:, i:i + cfg.block_len])
    assert sess.frames_seen >= 4, sess.frames_seen
    assert updates, "no telemetry decoded"
    ch, telem = updates[-1]
    assert ch == 0
    assert telem.serial == "S1234567"
    assert telem.lat == pytest.approx(45.0, abs=1e-5)
    assert telem.lon == pytest.approx(9.0, abs=1e-5)
    assert telem.alt == pytest.approx(12000.0, abs=0.1)
    # all frame numbers distinct and increasing
    seqs = sorted({t.seq for _, t in updates})
    assert len(seqs) >= 4
    assert seqs == sorted(seqs)


def test_rs41_end_to_end_noisy_10db():
    """FER at 10 dB SNR must be ~0 for the clean-channel chain
    (BASELINE.json:5 'FER matching the CPU reference at 10 dB SNR')."""
    iq, truths = _make_iq(n_frames=8, snr_db=10.0)
    cfg = PipelineConfig(sonde="rs41", channels=1, block_len=48000)
    sess = DecoderSession(cfg)
    count = 0
    n = iq.shape[1]
    for i in range(0, n - cfg.block_len + 1, cfg.block_len):
        count += len(sess.process_block(iq[:, i:i + cfg.block_len]))
    assert count >= 6, f"only {count} frames decoded at 10 dB"


def test_rs41_multichannel_independent_streams():
    """Each channel decodes its own stream (different serial per channel)."""
    mod = RS41Modulator()
    fs = 48000.0
    chans = []
    serials = ["AAA00001", "BBB00002", "CCC00003"]
    for s in serials:
        truths = [RS41Truth(frame_no=50 + i, serial=s, alt=10000.0 + 10 * i)
                  for i in range(4)]
        chans.append(mod.modulate(truths, fs=fs))
    nmin = min(x.size for x in chans)
    iq = np.stack([x[:nmin] for x in chans])
    cfg = PipelineConfig(sonde="rs41", channels=3, block_len=48000)
    sess = DecoderSession(cfg)
    for i in range(0, nmin - cfg.block_len + 1, cfg.block_len):
        sess.process_block(iq[:, i:i + cfg.block_len])
    for c, s in enumerate(serials):
        assert c in sess.telemetry, f"channel {c} decoded nothing"
        assert sess.telemetry[c].serial == s


def test_host_workers_parallel_decode_matches_serial():
    """host_workers>1 (channel-sharded thread-pool parse) yields the same
    telemetry as the serial path — workers own disjoint channel ranges so
    per-channel decoder state stays single-writer."""
    mod = RS41Modulator()
    fs = 48000.0
    serials = [f"W{k:07d}" for k in range(8)]
    chans = []
    for s in serials:
        truths = [RS41Truth(frame_no=10 + i, serial=s, alt=5000.0 + 100 * i)
                  for i in range(4)]
        chans.append(mod.modulate(truths, fs=fs))
    nmin = min(x.size for x in chans)
    iq = np.stack([x[:nmin] for x in chans])
    results = []
    for workers in (0, 3):
        cfg = PipelineConfig(sonde="rs41", channels=8, block_len=48000)
        sess = DecoderSession(cfg, host_workers=workers)
        ups = []
        for i in range(0, nmin - cfg.block_len + 1, cfg.block_len):
            ups += sess.process_block(iq[:, i:i + cfg.block_len])
        results.append((sorted((ch, t.seq, t.serial, t.alt) for ch, t in ups),
                        {c: sess.telemetry[c].serial for c in sess.telemetry}))
    assert results[0] == results[1]
    assert results[0][1] == {c: serials[c] for c in range(8)}


def test_rs41_block_size_invariance():
    """Chunked == unchunked (SURVEY.md §7: 'chunked decode == unchunked
    decode for any block size')."""
    iq, _ = _make_iq(n_frames=6)
    # zero-pad so every block size processes the identical sample stream
    lcm = 96000
    pad = (-iq.shape[1]) % lcm
    iq = np.pad(iq, ((0, 0), (0, pad)))
    results = {}
    for block in (24000, 48000, 96000):
        cfg = PipelineConfig(sonde="rs41", channels=1, block_len=block)
        sess = DecoderSession(cfg)
        n = iq.shape[1]
        for i in range(0, n - block + 1, block):
            sess.process_block(iq[:, i:i + block])
        results[block] = sess.frames_seen
    assert min(results.values()) >= 5, results
    assert max(results.values()) - min(results.values()) <= 1, results


def test_rs41_survives_frequency_offset():
    """Residual carrier offset appears as DC in FM audio; the dc_block stage
    must absorb a few hundred Hz."""
    iq, _ = _make_iq(n_frames=5)
    iq = np.stack([freq_shift(iq[0], 300.0 / 48000.0)])
    cfg = PipelineConfig(sonde="rs41", channels=1, block_len=48000)
    sess = DecoderSession(cfg)
    n = iq.shape[1]
    for i in range(0, n - cfg.block_len + 1, cfg.block_len):
        sess.process_block(iq[:, i:i + cfg.block_len])
    assert sess.frames_seen >= 3
    assert sess.telemetry[0].serial == "S1234567"


def test_rs41_fine_frequency_offset_ddc():
    """A sonde 4 kHz off the channel center decodes when the per-channel
    fine offset (DDC) is configured — the analogue of tuning the reference
    VFO off the channel grid (main.cpp:56)."""
    iq, _ = _make_iq(n_frames=4)
    iq = np.stack([freq_shift(iq[0], 4000.0 / 48000.0)])
    # without DDC the pre-demod channel filter clips the shifted spectrum
    cfg0 = PipelineConfig(sonde="rs41", channels=1, block_len=48000)
    sess0 = DecoderSession(cfg0)
    for i in range(0, iq.shape[1] - 48000 + 1, 48000):
        sess0.process_block(iq[:, i:i + 48000])
    # with DDC it decodes cleanly
    cfg = PipelineConfig(sonde="rs41", channels=1, block_len=48000,
                         fine_offsets=(4000.0,))
    sess = DecoderSession(cfg)
    for i in range(0, iq.shape[1] - 48000 + 1, 48000):
        sess.process_block(iq[:, i:i + 48000])
    assert sess.frames_seen >= 2
    assert sess.telemetry[0].serial == "S1234567"
    assert sess.frames_seen > sess0.metrics.frames_decoded or \
        sess.metrics.frames_decoded >= sess0.metrics.frames_decoded


def test_int16_device_dequant_matches_f32():
    """input_dtype="i16": raw int16 planes upload and dequantize on device;
    decoding a 16-bit-quantized stream matches the float path on the same
    quantized data (the wire is 2x narrower, the math identical)."""
    iq, _ = _make_iq(n_frames=5, snr_db=10.0)
    # quantize exactly like io.iq.write_iq cs16
    qi = np.clip(np.round(iq.real * 32767), -32768, 32767).astype(np.int16)
    qq = np.clip(np.round(iq.imag * 32767), -32768, 32767).astype(np.int16)

    cfg_i = PipelineConfig(sonde="rs41", channels=1, block_len=48000,
                           input_dtype="i16")
    cfg_f = PipelineConfig(sonde="rs41", channels=1, block_len=48000)
    sess_i = DecoderSession(cfg_i)
    sess_f = DecoderSession(cfg_f)
    n = iq.shape[1]
    seqs_i, seqs_f = [], []
    for i in range(0, n - 48000 + 1, 48000):
        up_i = sess_i.process_block((qi[:, i:i + 48000], qq[:, i:i + 48000]))
        up_f = sess_f.process_block(
            (qi[:, i:i + 48000].astype(np.float32) / 32768.0,
             qq[:, i:i + 48000].astype(np.float32) / 32768.0))
        seqs_i += [t.seq for _, t in up_i]
        seqs_f += [t.seq for _, t in up_f]
    assert seqs_i == seqs_f and len(seqs_i) >= 3
    assert sess_i.telemetry[0].serial == "S1234567"
    # complex input is rejected on an integer-ingest pipeline
    with pytest.raises(TypeError):
        sess_i.pipeline.step(sess_i.state, iq[:, :48000])


def test_bf16_compute_decodes_at_10db():
    """compute_dtype="bf16" (sample-rate arrays stored bfloat16, reductions
    f32) must decode at 10 dB SNR like the f32 path — bf16 quantization
    (~0.4% relative) sits far below channel noise at any decodable SNR."""
    iq, _ = _make_iq(n_frames=8, snr_db=10.0)
    cfg = PipelineConfig(sonde="rs41", channels=1, block_len=48000,
                         compute_dtype="bf16")
    sess = DecoderSession(cfg)
    count = 0
    n = iq.shape[1]
    for i in range(0, n - 48000 + 1, 48000):
        count += len(sess.process_block(iq[:, i:i + 48000]))
    assert count >= 6, f"only {count} frames decoded at 10 dB in bf16"
    assert sess.telemetry[0].serial == "S1234567"


def test_bf16_block_size_invariance():
    """Chunked bf16 decode equals a different chunking (carry dtypes are
    consistent across steps)."""
    iq, _ = _make_iq(n_frames=6)
    seqs = {}
    for bl in (24000, 48000):
        cfg = PipelineConfig(sonde="rs41", channels=1, block_len=bl,
                             compute_dtype="bf16")
        sess = DecoderSession(cfg)
        got = []
        for i in range(0, iq.shape[1] - bl + 1, bl):
            got += [t.seq for _, t in sess.process_block(iq[:, i:i + bl])]
        seqs[bl] = got
    assert seqs[24000] == seqs[48000] and len(seqs[48000]) >= 4


def test_bf16_rejects_afsk_and_pallas():
    # bf16 is refused for AFSK alone; the kernel knob is refused for every
    # family it cannot serve, whatever the dtype, and accepted in bf16 for
    # the dual-tone families
    with pytest.raises(ValueError):
        PipelineConfig(sonde="imet4", compute_dtype="bf16")
    with pytest.raises(ValueError):
        PipelineConfig(sonde="rs41", compute_dtype="bf16", use_pallas=True)
    assert PipelineConfig(sonde="m10", compute_dtype="bf16",
                          use_pallas=True).use_pallas
