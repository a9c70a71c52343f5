"""The fused dual-tone kernel (sondetpu/pallas/dualtone.py) in the Pallas
interpreter, against a float64 model of the jnp path and against the
pipeline's jnp path itself; plus the knob's rules."""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sondetpu.dsp.fir import design_lowpass
from sondetpu.pallas.dualtone import (dualtone_taps, fused_dualtone_frontend,
                                      history)
from sondetpu.runtime.pipeline import Pipeline, PipelineConfig


def _jnp_model(x, chan, box, dov, skip):
    """Float64 model of the jnp dual-tone path over a whole stream from
    zero state: chanfilt, mix by the wrapped-phase table, boxcar, envelope
    metric, and the AFC rotation products."""
    c, n = x.shape
    ntaps = len(box)
    if skip:
        cf = x
    else:
        cf = np.stack([np.convolve(r, chan)[:n] for r in x])
    ang = 2 * np.pi * np.mod(np.arange(n) * dov, 1.0)
    lpp = np.stack([np.convolve(r, box)[:n] for r in cf * np.exp(-1j * ang)])
    lpm = np.stack([np.convolve(r, box)[:n] for r in cf * np.exp(1j * ang)])
    pp, pm = np.abs(lpp) ** 2, np.abs(lpm) ** 2
    met = (pp - pm) / (pp + pm + 1e-12)
    rot = np.zeros((c, n), complex)
    rot[:, 1:] = (lpp[:, 1:] * np.conj(lpp[:, :-1])
                  + lpm[:, 1:] * np.conj(lpm[:, :-1]))
    assert ntaps == len(chan)
    return met, rot


def _box(ntaps, nb):
    b = np.zeros(ntaps, np.float32)
    b[-nb:] = 1.0 / nb
    return b


# (skip_chanfilt, nb, dev/fs, block, dtype, tile): m10-like (skip, nb 5)
# and ims100-like (41-tap chanfilt, nb 20) families; ragged and
# chunk-multiple blocks; channel counts off the tile; bf16 planes
CASES = [
    (True, 5, 0.25, 1900, "f32", (4, 256, 4)),
    (False, 20, 0.05, 1900, "f32", (4, 256, 4)),
    (True, 5, 0.25, 2048, "f32", (8, 512, 4)),
    (False, 20, 0.05, 1024, "bf16", (1, 128, 4)),
]


@pytest.mark.parametrize("skip,nb,dov,n,dt,tile", CASES)
def test_kernel_matches_float64_model(skip, nb, dov, n, dt, tile):
    """Two consecutive blocks (the second reads the carried tail): metric,
    block-mean DC and AFC rotation sums against the float64 model."""
    ntaps, c = 41, 6
    chan = design_lowpass(10000.0, 48000.0, ntaps)
    box = _box(ntaps, nb)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(c, 2 * n)) + 1j * rng.normal(size=(c, 2 * n))
    cdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    # the kernel sees the stored dtype; model the same rounding
    xr = np.asarray(jnp.asarray(x.real, cdt).astype(jnp.float32), np.float64)
    xi = np.asarray(jnp.asarray(x.imag, cdt).astype(jnp.float32), np.float64)
    met, rot = _jnp_model(xr + 1j * xi, chan.astype(np.float64),
                          box.astype(np.float64), dov, skip)
    ct, bt = tuple(map(float, chan)), tuple(map(float, box))
    h = history(ct, bt, skip)
    ti = tq = jnp.zeros((c, h), cdt)
    for b in range(2):
        sl = slice(b * n, (b + 1) * n)
        m, ti, tq, dc, rre, rim = fused_dualtone_frontend(
            jnp.asarray(x.real[:, sl], cdt), jnp.asarray(x.imag[:, sl], cdt),
            ti, tq, chan_taps=ct, box=bt, dev_over_fs=dov,
            skip_chanfilt=skip, want_afc=True, interpret=True, tile=tile)
        assert m.shape == (c, n) and ti.shape == (c, h)
        np.testing.assert_allclose(np.asarray(m), met[:, sl], atol=5e-5)
        np.testing.assert_allclose(np.asarray(dc), met[:, sl].mean(axis=1),
                                   atol=1e-6)
        r = rot[:, sl][:, 1:].sum(axis=1)     # pairs t >= 1 of the block
        scale = np.abs(r).max()
        np.testing.assert_allclose(np.asarray(rre), r.real, atol=1e-5 * scale)
        np.testing.assert_allclose(np.asarray(rim), r.imag, atol=1e-5 * scale)


@pytest.mark.parametrize("skip", [True, False])
def test_combined_taps_equal_mix_then_boxcar(skip):
    """|G+ * x|^2 is the envelope of (mix by e^{-j ang}, then boxcar): the
    identity the kernel rests on, in float64 for an arbitrary stream."""
    ntaps, nb, dov = 41, 5, 0.25
    chan = design_lowpass(20000.0, 48000.0, ntaps).astype(np.float64)
    box = _box(ntaps, nb).astype(np.float64)
    gp, gm, k0 = dualtone_taps(chan, box, dov, skip)
    assert k0 == ntaps - nb                   # the jnp path's boxcar delay
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 800)) + 1j * rng.normal(size=(1, 800))
    met, _ = _jnp_model(x, chan, box, dov, skip)
    yp = np.convolve(x[0], gp)[:800]
    ym = np.convolve(x[0], gm)[:800]
    pp, pm = np.abs(yp) ** 2, np.abs(ym) ** 2
    np.testing.assert_allclose((pp - pm) / (pp + pm + 1e-12), met[0],
                               atol=1e-9)


def test_wrapper_rejects_wrong_tail_width():
    chan = tuple(map(float, design_lowpass(10000.0, 48000.0, 41)))
    box = tuple(map(float, _box(41, 5)))
    x = jnp.zeros((2, 512), jnp.float32)
    bad = jnp.zeros((2, history(chan, box, True) + 1), jnp.float32)
    with pytest.raises(ValueError, match="tail width"):
        fused_dualtone_frontend(x, x, bad, bad, chan_taps=chan, box=box,
                                dev_over_fs=0.25, skip_chanfilt=True,
                                interpret=True)


def _run(sonde, iq, use_pallas, afc=False, cdt="f32", mesh=None):
    cfg = PipelineConfig(sonde=sonde, channels=iq.shape[0], block_len=48000,
                         use_pallas=use_pallas, afc=afc, compute_dtype=cdt)
    p = Pipeline(cfg, mesh=mesh)
    assert p._kernel == bool(use_pallas)    # a silent fallback fails here
    st = p.init_state()
    outs = []
    for i in range(0, iq.shape[1] - 48000 + 1, 48000):
        st, out = p.step(st, iq[:, i:i + 48000])
        outs.append((np.asarray(out.frames), np.asarray(out.frame_valid)))
    return outs


def _family_iq(sonde, mod_cls, truth_cls, channels=8, seed=7):
    m = importlib.import_module(f"sondetpu.sondes.{sonde}")
    mod = getattr(m, mod_cls)()
    truths = [getattr(m, truth_cls)(frame_no=10 + i) for i in range(10)]
    iq = mod.modulate(truths)[None, :]
    rng = np.random.default_rng(seed)
    iq = iq + (0.03 * (rng.normal(size=iq.shape)
                       + 1j * rng.normal(size=iq.shape))).astype(np.complex64)
    return np.tile(iq, (channels, 1))


def _same_frames(a, b):
    total = 0
    for (fa, va), (fb, vb) in zip(a, b):
        np.testing.assert_array_equal(vb, va)
        np.testing.assert_array_equal(fb[vb], fa[va])
        total += int(va.sum())
    assert total > 0                     # the comparison saw real frames


@pytest.mark.parametrize("sonde,mod_cls,truth_cls", [
    ("m10", "M10Modulator", "M10Truth"),           # mean-DC dual-tone
    ("ims100", "IMS100Modulator", "IMS100Truth"),  # midpoint-DC dual-tone
    ("mrzn1", "MRZN1Modulator", "MRZN1Truth"),     # midpoint-DC dual-tone
])
def test_fused_dualtone_matches_jnp(sonde, mod_cls, truth_cls):
    """The kernel path decodes the SAME frames as the jnp dual-tone path
    for every noncoherent-FSK family."""
    iq = _family_iq(sonde, mod_cls, truth_cls, channels=5)
    _same_frames(_run(sonde, iq, False), _run(sonde, iq, "interpret"))


def test_fused_dualtone_afc_tracks_offset():
    """AFC on the kernel path: the kernel's envelope-rotation sums pull the
    tracked frequency of an m10 channel 800 Hz off grid toward +800 Hz."""
    from sondetpu.runtime.session import DecoderSession
    from sondetpu.sondes.m10 import M10Modulator, M10Truth

    fs = 48000.0
    iq = M10Modulator().modulate([M10Truth(frame_no=i) for i in range(30)],
                                 fs=fs)
    n = iq.size
    sig = (iq * np.exp(2j * np.pi * 800.0 * np.arange(n) / fs)
           ).astype(np.complex64)
    rng = np.random.default_rng(0)
    sig = sig + (0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
                 ).astype(np.complex64)
    sig = np.tile(sig[None, :], (3, 1))
    cfg = PipelineConfig(sonde="m10", channels=3, block_len=48000,
                         use_pallas="interpret", afc=True)
    sess = DecoderSession(cfg)
    assert sess.pipeline._kernel
    for b in range(sig.shape[1] // 48000):
        sess.process_block(sig[:, b * 48000:(b + 1) * 48000])
    f = sess.afc_freqs[0]
    assert 400.0 < f < 1200.0, f
    assert sess.metrics.frames_decoded > 0


def test_fused_dualtone_bf16_storage_decode_parity():
    """compute_dtype='bf16' on the kernel path (bf16 planes in, f32
    arithmetic) decodes the frames of the f32 kernel path."""
    iq = _family_iq("m10", "M10Modulator", "M10Truth", channels=3, seed=5)
    _same_frames(_run("m10", iq, "interpret"),
                 _run("m10", iq, "interpret", cdt="bf16"))


def test_kernel_under_mesh_matches_single_device():
    """Under a mesh the kernel runs once per channel shard (shard_map): the
    sharded step decodes exactly the single-device frames."""
    from sondetpu.parallel import make_mesh
    from sondetpu.parallel.sharding import shard_channels

    mesh = make_mesh(devices=jax.devices()[:4])
    iq = _family_iq("m10", "M10Modulator", "M10Truth", channels=4)[:, :48000]
    want = _run("m10", iq, "interpret")
    cfg = PipelineConfig(sonde="m10", channels=4, block_len=48000,
                         use_pallas="interpret")
    p = Pipeline(cfg, mesh=mesh)
    st = shard_channels(p.init_state(), mesh)
    step = jax.jit(p._step_impl)
    got = []
    for i in range(0, iq.shape[1], 48000):
        blk = iq[:, i:i + 48000]
        st, out = step(
            st, shard_channels(np.ascontiguousarray(blk.real), mesh),
            shard_channels(np.ascontiguousarray(blk.imag), mesh))
        got.append((np.asarray(out.frames), np.asarray(out.frame_valid)))
    _same_frames(want, got)


def test_compiled_kernel_requested_off_gpu_raises():
    """use_pallas=True compiles for a GPU only; on another backend the
    pipeline refuses rather than interpret or fall back quietly."""
    assert jax.default_backend() != "gpu"
    cfg = PipelineConfig(sonde="m10", channels=2, block_len=48000,
                         use_pallas=True)
    with pytest.raises(ValueError, match="interpret"):
        Pipeline(cfg)


@pytest.mark.parametrize("sonde", ["rs41", "dfm", "imet4"])
def test_kernel_refused_for_other_families(sonde):
    """The knob means the dual-tone kernel alone: a family it cannot serve
    raises at config time."""
    with pytest.raises(ValueError, match="dual-tone"):
        PipelineConfig(sonde=sonde, channels=2, use_pallas="interpret")


def test_use_pallas_values():
    with pytest.raises(ValueError, match="use_pallas"):
        PipelineConfig(sonde="m10", channels=2, use_pallas="yes")


@pytest.mark.gpu
def test_compiled_kernel_matches_interpreter(gpu):
    """On a card: the Triton-compiled kernel equals the interpreter."""
    chan = tuple(map(float, design_lowpass(10000.0, 48000.0, 41)))
    box = tuple(map(float, _box(41, 20)))
    h = history(chan, box, False)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(10, 5000)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(10, 5000)), jnp.float32)
    t = jnp.zeros((10, h), jnp.float32)
    kw = dict(chan_taps=chan, box=box, dev_over_fs=0.05, skip_chanfilt=False,
              want_afc=True)
    got = fused_dualtone_frontend(x, y, t, t, **kw)
    want = fused_dualtone_frontend(x, y, t, t, interpret=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)
