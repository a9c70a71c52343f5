"""Wideband spectrum scan + automatic sonde-type classification.

In the reference, finding a sonde is a human workflow: watch the SDR++
waterfall, drag a VFO onto the carrier (main.cpp:55-56, snap 1000 Hz), and
pick the protocol from the type combobox (main.cpp:136-151).  This module
automates both steps on the device:

1. :func:`welch_psd` — averaged periodogram of the wideband block:
   segmented, Hann-windowed, computed with the channelizer's mixed-radix
   DFT on real I/Q planes (no complex64 in compiled programs, same
   rule as the rest of the framework).
2. :func:`detect_carriers` — host-side peak grouping of the PSD into
   candidate carriers (center / bandwidth / SNR over a median noise
   floor).  This is the waterfall-squint step.
3. :func:`classify_carriers` — channelize ONCE with the PFB, then run
   every candidate channel through each registered family's compiled
   decode probe as a batch; a family claims a carrier when its frames
   actually parse (sync + FEC + CRC all pass), the highest decoded count
   winning (ties go to the earlier registry entry).  This is the combobox
   step, done by decoding rather than guessing.

The result plugs straight into the wideband fleet: :func:`scan_to_config`
emits the ``channel_map`` consumed by ``decode --wideband``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from sondetpu.dsp.channelizer import PFBChannelizer, _dft_axis0


# ---------------------------------------------------------------------------
# 1. spectrum estimate
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("nfft",))
def _psd_impl(si: jax.Array, sq: jax.Array, nfft: int):
    """Mean Hann-windowed periodogram of segments. si/sq: [nfft, nseg]."""
    win = jnp.asarray(np.hanning(nfft).astype(np.float32))[:, None]
    yi, yq = _dft_axis0(si * win, sq * win, sign=-1.0)
    return jnp.mean(yi * yi + yq * yq, axis=1)


def welch_psd(x_i: np.ndarray, x_q: np.ndarray, nfft: int = 4096):
    """Averaged power spectrum of a wideband I/Q capture.

    Returns ``(freqs, psd)`` with frequencies ascending from -fs/2 (in
    *normalized* cycles/sample times fs applied by the caller) — i.e.
    ``freqs`` is in bins here; multiply by ``fs_wide / nfft`` for Hz.
    """
    n = (x_i.shape[-1] // nfft) * nfft
    if n == 0:
        raise ValueError(f"need at least nfft={nfft} samples")
    si = np.ascontiguousarray(
        np.reshape(x_i[:n], (-1, nfft)).T.astype(np.float32))
    sq = np.ascontiguousarray(
        np.reshape(x_q[:n], (-1, nfft)).T.astype(np.float32))
    psd = np.asarray(_psd_impl(si, sq, nfft))
    # natural DFT order -> ascending frequency (negative half first)
    psd = np.fft.fftshift(psd)
    bins = np.arange(nfft) - nfft // 2
    return bins, psd


# ---------------------------------------------------------------------------
# 2. carrier detection
# ---------------------------------------------------------------------------

@dataclass
class Carrier:
    """One detected emission in the wideband span."""

    center_hz: float
    bw_hz: float
    snr_db: float
    power: float = 0.0
    sonde: Optional[str] = None     # filled by classify_carriers
    frames: int = 0                 # decoded frames backing the claim
    scores: Dict[str, int] = field(default_factory=dict)


def detect_carriers(iq: np.ndarray, fs_wide: float, nfft: int = 4096,
                    min_snr_db: float = 8.0, merge_hz: float = 4000.0,
                    min_bw_hz: float = 800.0, max_carriers: int = 64,
                    ) -> List[Carrier]:
    """Find active emissions in a wideband capture.

    ``iq`` is complex64 (host) or an (i, q) float32 plane pair.  The noise
    floor is the PSD median (sondes occupy a tiny fraction of a wideband
    span); bins more than ``min_snr_db`` above it are grouped into runs,
    runs closer than ``merge_hz`` merge (GFSK spectra are double-lobed),
    and each run becomes a :class:`Carrier` at its power centroid.
    """
    if isinstance(iq, tuple):
        x_i, x_q = iq
    else:
        from sondetpu.io.iq import c64_to_planes
        x_i, x_q = c64_to_planes(np.asarray(iq))   # native deinterleaver
    bins, psd = welch_psd(x_i, x_q, nfft)
    hz_per_bin = fs_wide / nfft
    # light smoothing (~500 Hz) so double-lobed FSK spectra group cleanly
    k = max(1, int(round(500.0 / hz_per_bin)))
    if k > 1:
        psd = np.convolve(psd, np.ones(k, np.float32) / k, mode="same")
    floor = float(np.median(psd))
    thresh = floor * 10.0 ** (min_snr_db / 10.0)
    mask = psd > thresh

    # group mask runs, merging gaps below merge_hz
    gap = max(1, int(round(merge_hz / hz_per_bin)))
    runs: List[Tuple[int, int]] = []   # [start, end) bin index ranges
    idx = np.flatnonzero(mask)
    if idx.size == 0:
        return []
    start = prev = idx[0]
    for i in idx[1:]:
        if i - prev > gap:
            runs.append((start, prev + 1))
            start = i
        prev = i
    runs.append((start, prev + 1))

    # the spectrum is circular: a carrier near +/-fs/2 has energy on both
    # edges of the fftshifted PSD — merge edge runs across the wrap so a
    # near-Nyquist sonde is ONE carrier, not a main lobe plus an alias tail
    # (combined circular gap — each run being near ITS edge is not enough,
    # or two carriers up to 2*merge_hz apart across the fold would merge)
    wrap = (len(runs) >= 2
            and runs[0][0] + (nfft - runs[-1][1]) <= gap)
    out: List[Carrier] = []
    for ri, (a, b) in enumerate(runs):
        if wrap and ri == len(runs) - 1:
            continue                       # consumed by the first run below
        p = np.clip(psd[a:b] - floor, 0.0, None)
        f = bins[a:b].astype(np.float64)
        width = b - a
        pk = float(psd[a:b].max())
        if wrap and ri == 0:
            a2, b2 = runs[-1]
            # unwrap the top-edge run below -fs/2 so the centroid is right;
            # span the circular gap like linear merging spans in-band gaps
            p = np.concatenate([np.clip(psd[a2:b2] - floor, 0.0, None), p])
            f = np.concatenate([bins[a2:b2].astype(np.float64) - nfft, f])
            width += (b2 - a2) + a + (nfft - b2)
            pk = max(pk, float(psd[a2:b2].max()))
        tot = float(p.sum())
        if tot <= 0.0:
            continue
        center = float((f * p).sum() / tot) * hz_per_bin
        # wrap the centroid back into [-fs/2, fs/2)
        center = (center + fs_wide / 2.0) % fs_wide - fs_wide / 2.0
        bw = width * hz_per_bin
        if bw < min_bw_hz:
            continue
        snr = 10.0 * np.log10(pk / max(floor, 1e-30))
        out.append(Carrier(center_hz=center, bw_hz=bw, snr_db=snr, power=tot))
    out.sort(key=lambda c: -c.power)
    return out[:max_carriers]


# ---------------------------------------------------------------------------
# 3. classification by decode probe
# ---------------------------------------------------------------------------

def classify_carriers(iq, fs_wide: float, carriers: Sequence[Carrier],
                      fs_chan: float = 48000.0, block_len: int = 48000,
                      families: Optional[Sequence[str]] = None,
                      sync_threshold: float = 0.55,
                      min_frames: int = 1) -> List[Carrier]:
    """Identify the protocol on each detected carrier by decoding it.

    The wideband capture is PFB-channelized once; each carrier maps to its
    nearest bin plus a fine DDC offset (the VFO-snap analogue,
    main.cpp:56).  Then for every candidate family a probe
    :class:`DecoderSession` runs ALL carriers as one channel batch; the
    per-carrier telemetry-update counts are the evidence.  A carrier is
    claimed by the family that decoded the most frames on it (ties to the
    earlier registry entry); carriers nothing decodes keep ``sonde=None``.

    Mutates and returns ``carriers`` (``sonde``, ``frames``, ``scores``).
    """
    from sondetpu.runtime.pipeline import PipelineConfig
    from sondetpu.runtime.session import DecoderSession
    from sondetpu.sondes import SUPPORTED_TYPES

    carriers = list(carriers)
    if not carriers:
        return carriers
    n_bins = int(round(fs_wide / fs_chan))
    if abs(n_bins * fs_chan - fs_wide) > 1e-6 or n_bins < 2:
        raise ValueError(
            f"fs_wide={fs_wide} must be an integer multiple (>=2) of "
            f"fs_chan={fs_chan} to channelize for classification")
    if isinstance(iq, tuple):
        x_i, x_q = iq
    else:
        from sondetpu.io.iq import c64_to_planes
        x_i, x_q = c64_to_planes(np.asarray(iq))   # native deinterleaver

    # channelize once; probe blocks are shared by every family
    pfb = PFBChannelizer(n_bins)
    st = pfb.init_state()
    w = n_bins * block_len
    blocks: List[Tuple[np.ndarray, np.ndarray]] = []
    for s in range(0, x_i.shape[-1] - w + 1, w):
        st, yi, yq = pfb(st, x_i[s:s + w], x_q[s:s + w])
        blocks.append((np.asarray(yi), np.asarray(yq)))
    if not blocks:
        raise ValueError(f"capture too short: need {w} wideband samples "
                         f"per probe block")

    bins_sel: List[int] = []
    resids: List[float] = []
    for c in carriers:
        k, resid = pfb.bin_and_offset(c.center_hz, fs_chan)
        bins_sel.append(k)
        resids.append(resid)

    fams = list(families) if families is not None else list(SUPPORTED_TYPES)
    counts: Dict[str, np.ndarray] = {}
    for fam in fams:
        cfg = PipelineConfig(
            sonde=fam, channels=len(carriers), fs=fs_chan,
            block_len=block_len, sync_threshold=sync_threshold,
            fine_offsets=tuple(resids) if any(resids) else None)
        sess = DecoderSession(cfg)
        n_upd = np.zeros(len(carriers), np.int64)
        for yi, yq in blocks:
            gi = np.ascontiguousarray(yi[bins_sel])
            gq = np.ascontiguousarray(yq[bins_sel])
            for ch, _t in sess.process_block((gi, gq)):
                n_upd[ch] += 1
        counts[fam] = n_upd

    for i, c in enumerate(carriers):
        c.scores = {f: int(counts[f][i]) for f in fams if counts[f][i] > 0}
        # ties go to the earlier registry entry; measured on-air case:
        # rs41x (the extended superset decoder) parses standard RS41 frames
        # too, so a standard carrier ties rs41==rs41x and resolves to rs41,
        # while a genuine extended carrier scores rs41x strictly higher
        best = max(fams, key=lambda f: counts[f][i])
        if counts[best][i] >= min_frames:
            c.sonde = best
            c.frames = int(counts[best][i])
    return carriers


def scan_to_config(carriers: Sequence[Carrier], cfg=None,
                   fs_wide: Optional[float] = None):
    """Fill a :class:`FrameworkConfig` channel_map from classified carriers
    (classified ones only), ready for ``decode --wideband --config``.
    ``fs_wide`` also bakes the PFB bin count so decode needs no --bins."""
    from sondetpu.cli.config import ChannelConfig, FrameworkConfig

    cfg = cfg or FrameworkConfig()
    cfg.wideband = True
    if fs_wide is not None:
        cfg.wide_bins = int(round(fs_wide / cfg.fs))
    cfg.channel_map = [
        ChannelConfig(center_freq=float(c.center_hz), sonde=c.sonde)
        for c in carriers if c.sonde is not None]
    return cfg
