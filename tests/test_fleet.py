"""Mixed-fleet wideband test (BASELINE.json:11): RS41 + M10 + DFM sondes in
different PFB bins of one wideband stream, decoded concurrently."""

import numpy as np
import pytest

from sondetpu.runtime.fleet import FleetChannel, FleetSession
from sondetpu.sondes.modulate import freq_shift, gfsk_modulate


def _narrowband_at_wideband(bits, chip_rate, dev, fs_wide, f_center, bt=0.5):
    iq = gfsk_modulate(bits, fs_wide / chip_rate, dev / fs_wide, bt=bt)
    return freq_shift(iq, f_center / fs_wide)


@pytest.mark.parametrize("use_pallas", [False, "interpret"])
def test_mixed_fleet_wideband(use_pallas):
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth
    from sondetpu.sondes.m10 import M10Modulator, M10Truth
    from sondetpu.sondes.dfm import DFMModulator, DFMTruth
    from sondetpu.sync.coding import np_bytes_to_bits

    n_bins = 8
    fs_chan = 48000.0
    fs_wide = n_bins * fs_chan

    fleet = FleetSession(
        channels=[FleetChannel(pfb_bin=1, sonde="rs41"),
                  FleetChannel(pfb_bin=3, sonde="m10"),
                  FleetChannel(pfb_bin=6, sonde="dfm")],
        n_bins=n_bins, use_pallas=use_pallas)
    # the knob engages the dual-tone kernel for the m10 group alone (a
    # silent jnp fallback fails here); single-channel groups need no pad
    for sonde, (idxs, sess) in fleet.groups.items():
        assert sess.config.channels == 1, sonde
        assert sess.pipeline._kernel == (bool(use_pallas)
                                         and sonde == "m10"), sonde
    centers = fleet.pfb.center_freqs(fs_wide)

    rs41 = RS41Modulator()
    rs41_bits = rs41.frames_to_bits(np.stack(
        [rs41.build_frame(RS41Truth(frame_no=40 + i)) for i in range(3)]))
    sig_rs41 = _narrowband_at_wideband(rs41_bits, 4800.0, 2400.0, fs_wide,
                                       centers[1])

    m10 = M10Modulator()
    m10_chips = m10.frames_to_chips(np.stack(
        [m10.build_frame(M10Truth(frame_no=8 + i)) for i in range(10)]))
    sig_m10 = _narrowband_at_wideband(m10_chips, 9600.0, 12000.0, fs_wide,
                                      centers[3], bt=0.7)

    dfm = DFMModulator()
    dfm_chips = dfm.frames_to_chips(np.stack(
        [dfm.build_frame(DFMTruth(frame_no=2 + k), k) for k in range(8)]))
    sig_dfm = _narrowband_at_wideband(dfm_chips, 2500.0, 2500.0, fs_wide,
                                      centers[6])

    w = n_bins * 48000
    n = max(sig_rs41.size, sig_m10.size, sig_dfm.size)
    n = ((n + w - 1) // w) * w
    wide = np.zeros(n, np.complex64)
    wide[:sig_rs41.size] += sig_rs41
    wide[:sig_m10.size] += sig_m10
    wide[:sig_dfm.size] += sig_dfm

    for i in range(0, n - w + 1, w):
        fleet.process_wideband(wide[i:i + w])

    telem = fleet.telemetry
    # dummy pad channels never surface in fleet telemetry
    assert set(telem) <= {0, 1, 2}
    assert 0 in telem and telem[0].serial == "S1234567"
    assert 1 in telem and telem[1].serial == "910-2-12345"
    assert 2 in telem and telem[2].serial == "1234567"
    assert telem[0].lat == pytest.approx(45.0, abs=1e-4)
    assert telem[1].lat == pytest.approx(52.2, abs=1e-4)
    assert telem[2].lat == pytest.approx(47.0, abs=1e-4)


def test_mixed_fleet_sharded_over_mesh():
    """Heterogeneous fleet with a type group whose channel axis is sharded
    over the 8-device mesh (BASELINE.json:11 "Mixed-fleet wideband: 1000+
    heterogeneous channels sharded across N>=2 hosts", exercised here on
    the virtual CPU mesh): 16 RS41 channels (sharded 8-way SPMD) + 1 M10
    channel (single-device) in one wideband stream."""
    from sondetpu.parallel import make_mesh
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth
    from sondetpu.sondes.m10 import M10Modulator, M10Truth

    n_bins = 32
    fs_chan = 48000.0
    fs_wide = n_bins * fs_chan
    mesh = make_mesh()

    chans = [FleetChannel(pfb_bin=1 + k, sonde="rs41") for k in range(16)]
    chans.append(FleetChannel(pfb_bin=20, sonde="m10"))
    fleet = FleetSession(chans, n_bins=n_bins, mesh=mesh)
    rs_sess = fleet.groups["rs41"][1]
    m10_sess = fleet.groups["m10"][1]
    assert rs_sess.mesh is mesh          # 16 % 8 == 0 -> sharded
    assert m10_sess.mesh is None         # 1 channel stays single-device

    centers = fleet.pfb.center_freqs(fs_wide)
    rs41 = RS41Modulator()
    bits = rs41.frames_to_bits(np.stack(
        [rs41.build_frame(RS41Truth(frame_no=30 + i)) for i in range(3)]))
    m10 = M10Modulator()
    m10_chips = m10.frames_to_chips(np.stack(
        [m10.build_frame(M10Truth(frame_no=8 + i)) for i in range(10)]))

    w = n_bins * 48000
    sigs = [_narrowband_at_wideband(bits, 4800.0, 2400.0, fs_wide,
                                    centers[1 + k]) for k in range(16)]
    sigs.append(_narrowband_at_wideband(m10_chips, 9600.0, 12000.0, fs_wide,
                                        centers[20], bt=0.7))
    n = ((max(s.size for s in sigs) + w - 1) // w) * w
    wide = np.zeros(n, np.complex64)
    for s in sigs:
        wide[:s.size] += s

    for i in range(0, n - w + 1, w):
        fleet.process_wideband(wide[i:i + w])

    telem = fleet.telemetry
    for k in range(16):
        assert k in telem and telem[k].serial == "S1234567", k
        assert telem[k].lat == pytest.approx(45.0, abs=1e-4)
    assert 16 in telem and telem[16].serial == "910-2-12345"


def test_mixed_fleet_bf16_gates_afsk_groups():
    """compute_dtype="bf16" on a mixed fleet: GFSK groups run bf16, AFSK
    groups fall back to f32, and both still decode."""
    from sondetpu.runtime.fleet import FleetChannel, FleetSession
    fleet = FleetSession(
        [FleetChannel(pfb_bin=1, sonde="rs41"),
         FleetChannel(pfb_bin=3, sonde="imet4")],
        n_bins=4, compute_dtype="bf16")
    _, sess_rs41 = fleet.groups["rs41"]
    _, sess_imet4 = fleet.groups["imet4"]
    assert sess_rs41.config.compute_dtype == "bf16"
    assert sess_imet4.config.compute_dtype == "f32"
    assert fleet.pfb.dtype == "bf16"     # the channelizer rides bf16 too


def test_mixed_fleet_bf16_pfb_decode_parity():
    """A bf16 fleet (bf16 PFB FIR + DFT stages, bf16 NRZ groups) decodes
    the same telemetry as the f32 fleet on the same noisy wideband stream
    — the acceptance evidence for the r5 bf16-PFB lever."""
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth
    from sondetpu.sondes.m10 import M10Modulator, M10Truth

    n_bins = 8
    fs_wide = n_bins * 48000.0
    rs41 = RS41Modulator()
    bits = rs41.frames_to_bits(np.stack(
        [rs41.build_frame(RS41Truth(frame_no=40 + i)) for i in range(3)]))
    m10 = M10Modulator()
    chips = m10.frames_to_chips(np.stack(
        [m10.build_frame(M10Truth(frame_no=8 + i)) for i in range(10)]))

    results = {}
    for cdt in ("f32", "bf16"):
        fleet = FleetSession(
            [FleetChannel(pfb_bin=1, sonde="rs41"),
             FleetChannel(pfb_bin=5, sonde="m10")],
            n_bins=n_bins, compute_dtype=cdt)
        assert fleet.pfb.dtype == cdt.replace("f32", "f32")
        centers = fleet.pfb.center_freqs(fs_wide)
        sig_a = _narrowband_at_wideband(bits, 4800.0, 2400.0, fs_wide,
                                        centers[1])
        sig_b = _narrowband_at_wideband(chips, 9600.0, 12000.0, fs_wide,
                                        centers[5], bt=0.7)
        w = n_bins * 48000
        n = ((max(sig_a.size, sig_b.size) + w - 1) // w) * w
        wide = np.zeros(n, np.complex64)
        wide[:sig_a.size] += sig_a
        wide[:sig_b.size] += sig_b
        rng = np.random.default_rng(2)
        wide += (0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
                 ).astype(np.complex64)
        for i in range(0, n - w + 1, w):
            fleet.process_wideband(wide[i:i + w])
        results[cdt] = {ch: (t.serial, round(t.lat, 4))
                        for ch, t in fleet.telemetry.items()}
    assert results["bf16"] == results["f32"]
    assert results["f32"][0][0] == "S1234567"
    assert results["f32"][1][0] == "910-2-12345"


def test_fleet_checkpoint_roundtrip(tmp_path):
    """Fleet checkpoint/resume: PFB carry + every group's device/host state
    survive a restart (SURVEY.md §5.4 extended to mixed fleets)."""
    from sondetpu.runtime import checkpoint as ckpt
    from sondetpu.runtime.fleet import FleetChannel, FleetSession
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth

    n_bins = 4
    fs_wide = n_bins * 48000.0
    chans = [FleetChannel(pfb_bin=1, sonde="rs41"),
             FleetChannel(pfb_bin=3, sonde="m10")]
    fleet = FleetSession(chans, n_bins=n_bins)
    centers = fleet.pfb.center_freqs(fs_wide)

    rs41 = RS41Modulator()
    bits = rs41.frames_to_bits(np.stack(
        [rs41.build_frame(RS41Truth(frame_no=7 + i)) for i in range(3)]))
    wide = _narrowband_at_wideband(bits, 4800.0, 2400.0, fs_wide, centers[1])
    w = n_bins * 48000
    n = ((wide.size + w - 1) // w) * w
    full = np.zeros(n, np.complex64)
    full[:wide.size] = wide

    fleet.process_wideband(full[:w])
    path = tmp_path / "fleet.ckpt"
    ckpt.save_fleet(fleet, str(path))

    # a fresh fleet resumes and continues mid-stream: same telemetry as an
    # uninterrupted run
    fleet2 = FleetSession(chans, n_bins=n_bins)
    ckpt.load_fleet(fleet2, str(path))
    for blk in (fleet, fleet2):
        for i in range(w, n - w + 1, w):
            blk.process_wideband(full[i:i + w])
    t1, t2 = fleet.telemetry, fleet2.telemetry
    assert 0 in t1 and 0 in t2
    assert t1[0].serial == t2[0].serial == "S1234567"
    assert t1[0].seq == t2[0].seq

    # layout mismatch rejected
    other = FleetSession([FleetChannel(pfb_bin=1, sonde="rs41")], n_bins=n_bins)
    with pytest.raises(ValueError):
        ckpt.load_fleet(other, str(path))


def test_fleet_pipelined_flush_recovers_last_block():
    """Pipelined fleets hold block k's output until block k+1 dispatches;
    flush() must drain the final pending block or its frames are lost."""
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth

    n_bins = 4
    fs_wide = n_bins * 48000.0
    fleet = FleetSession([FleetChannel(pfb_bin=1, sonde="rs41")],
                         n_bins=n_bins, pipelined=True)
    centers = fleet.pfb.center_freqs(fs_wide)
    rs41 = RS41Modulator()
    bits = rs41.frames_to_bits(np.stack(
        [rs41.build_frame(RS41Truth(frame_no=5 + i)) for i in range(3)]))
    sig = _narrowband_at_wideband(bits, 4800.0, 2400.0, fs_wide, centers[1])
    w = n_bins * 48000
    n = ((sig.size + w - 1) // w) * w
    wide = np.zeros(n, np.complex64)
    wide[:sig.size] = sig
    ups = 0
    for i in range(0, n - w + 1, w):
        ups += fleet.process_wideband(wide[i:i + w])
    ups += fleet.flush()
    assert ups >= 3                     # incl. the final pending block
    assert fleet.telemetry[0].serial == "S1234567"


def test_autofleet_accepts_plane_pairs():
    """The streaming hot path feeds (i, q) plane pairs; AutoFleet must
    discover and decode from them (complex is rebuilt only at rescans)."""
    from sondetpu.runtime.autofleet import AutoFleet
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth

    n_bins = 8
    fs_wide = n_bins * 48000.0
    rs41 = RS41Modulator()
    bits = rs41.frames_to_bits(np.stack(
        [rs41.build_frame(RS41Truth(frame_no=8 + i)) for i in range(6)]))
    sig = _narrowband_at_wideband(bits, 4800.0, 2400.0, fs_wide,
                                  2 * 48000.0 + 1000.0)
    w = n_bins * 48000
    n = ((sig.size + w - 1) // w) * w
    wide = np.zeros(n, np.complex64)
    wide[:sig.size] = sig
    auto = AutoFleet(n_bins=n_bins, rescan_blocks=2, families=["rs41"])
    ups = 0
    for i in range(0, n - w + 1, w):
        blk = wide[i:i + w]
        ups += auto.process_wideband(
            (np.ascontiguousarray(blk.real), np.ascontiguousarray(blk.imag)))
    assert auto.tracked and auto.tracked[0].sonde == "rs41"
    assert ups >= 2
    telem = auto.telemetry
    assert telem and next(iter(telem.values()))[1].serial == "S1234567"


def test_mixed_fleet_with_afsk_member():
    """An AFSK family (iMet-4) decodes through the PFB + fleet path next to
    a GFSK member — the dual-tone front end gets real wideband coverage
    (prior mixed-fleet tests only fed GFSK members)."""
    from sondetpu.sondes.imet4 import IMET4Modulator, IMET4Truth
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth
    from sondetpu.sondes.modulate import freq_shift

    n_bins = 8
    fs_chan = 48000.0
    fs_wide = n_bins * fs_chan
    fleet = FleetSession([FleetChannel(pfb_bin=1, sonde="rs41"),
                          FleetChannel(pfb_bin=4, sonde="imet4")],
                         n_bins=n_bins)
    centers = fleet.pfb.center_freqs(fs_wide)

    rs41 = RS41Modulator()
    bits = rs41.frames_to_bits(np.stack(
        [rs41.build_frame(RS41Truth(frame_no=3 + i)) for i in range(3)]))
    sig_rs = _narrowband_at_wideband(bits, 4800.0, 2400.0, fs_wide, centers[1])

    imod = IMET4Modulator()
    nb = imod.modulate([IMET4Truth(frame_no=5 + i) for i in range(6)],
                       fs=fs_chan)
    # upsample the narrowband AFSK to the wideband rate (zero-order hold is
    # fine: images land outside the target bin) and shift to bin 4
    sig_im = freq_shift(np.repeat(nb, n_bins), centers[4] / fs_wide)

    w = int(n_bins * fs_chan)
    n = ((max(sig_rs.size, sig_im.size) + w - 1) // w) * w
    wide = np.zeros(n, np.complex64)
    wide[:sig_rs.size] += sig_rs
    wide[:sig_im.size] += sig_im.astype(np.complex64)

    for i in range(0, n - w + 1, w):
        fleet.process_wideband(wide[i:i + w])
    telem = fleet.telemetry
    # dummy pad channels never surface in fleet telemetry
    assert set(telem) <= {0, 1, 2}
    assert 0 in telem and telem[0].serial == "S1234567"
    assert 1 in telem
    assert telem[1].lat == pytest.approx(40.0, abs=1e-4)
    assert telem[1].pressure == pytest.approx(40.0, abs=0.1)


def test_fused_matches_unfused():
    """The single-dispatch fused fleet step (PFB + gathers + every group's
    front end in one program, one concatenated readback) must produce
    exactly the unfused path's telemetry — same PFB carry, same per-group
    states, same packed bytes."""
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth
    from sondetpu.sondes.m10 import M10Modulator, M10Truth

    n_bins = 8
    fs_wide = n_bins * 48000.0
    chans = [FleetChannel(pfb_bin=1, sonde="rs41"),
             FleetChannel(pfb_bin=3, sonde="m10")]
    rs41 = RS41Modulator()
    bits = rs41.frames_to_bits(np.stack(
        [rs41.build_frame(RS41Truth(frame_no=40 + i)) for i in range(3)]))
    m10 = M10Modulator()
    chips = m10.frames_to_chips(np.stack(
        [m10.build_frame(M10Truth(frame_no=8 + i)) for i in range(10)]))

    centers = None
    results = []
    for fused in (True, False):
        fleet = FleetSession(chans, n_bins=n_bins, fused=fused)
        assert fleet._fused is fused
        if centers is None:
            centers = fleet.pfb.center_freqs(fs_wide)
            sig = (_narrowband_at_wideband(bits, 4800.0, 2400.0, fs_wide,
                                           centers[1]),
                   _narrowband_at_wideband(chips, 9600.0, 12000.0, fs_wide,
                                           centers[3], bt=0.7))
            w = n_bins * 48000
            n = ((max(s.size for s in sig) + w - 1) // w) * w
            wide = np.zeros(n, np.complex64)
            for s in sig:
                wide[:s.size] += s
        ups = 0
        for i in range(0, n - w + 1, w):
            ups += fleet.process_wideband(wide[i:i + w])
        ups += fleet.flush()
        telem = fleet.telemetry
        results.append((ups, {k: (t.serial, t.lat, t.alt, t.seq)
                              for k, t in telem.items()}))
    assert results[0] == results[1], results
