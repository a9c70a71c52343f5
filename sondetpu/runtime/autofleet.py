"""Self-managing wideband decoding: discover sondes as they launch.

The reference's operating model is a human watching the waterfall and
creating one module instance per sonde as carriers appear
(main.cpp:23,55-56,136-151).  :class:`AutoFleet` closes that loop for a
production receiver: every ``rescan_blocks`` wideband blocks it re-runs the
PSD carrier scan (dsp/scan.py) over the live stream, classifies carriers it
has not seen before by decode-probing buffered blocks, and extends the
fleet's channel map — new sondes start decoding without operator action,
and carriers that vanish are dropped after an idle timeout.

Fleet changes recompile the affected per-type pipeline (channel counts are
static shapes), so membership changes are applied only when the carrier
set actually changes; surviving groups whose channel list is unchanged keep
their device/host state (sessions are reused object-identically), and a
changed group re-synchronizes within a frame or two — the protocol's own
elasticity (SURVEY.md §5.3).  Last-known telemetry is kept at the AutoFleet
level across rebuilds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from sondetpu.dsp.scan import classify_carriers, detect_carriers
from sondetpu.runtime.fleet import FleetChannel, FleetSession
from sondetpu.telemetry import SondeTelemetry


@dataclass
class TrackedSonde:
    """One discovered emitter being decoded.

    ``pfb_bin``/``seed_offset_hz`` are the carrier's IDENTITY in the fleet
    (fixed at discovery — group layouts, state transplant, and checkpoints
    compare against them); ``center_hz`` is the LIVE estimate, refreshed
    from AFC each rescan so a drifting sonde keeps matching itself."""

    center_hz: float
    sonde: str
    pfb_bin: int = -1
    seed_offset_hz: float = 0.0
    last_update_block: int = 0
    found_block: int = 0
    telem: Optional[SondeTelemetry] = None   # last-known, survives rebuilds


class AutoFleet:
    """Wideband IQ in, telemetry out — channels managed automatically."""

    def __init__(self, n_bins: int, fs_chan: float = 48000.0,
                 block_len: int = 48000, rescan_blocks: int = 10,
                 min_snr_db: float = 8.0, families=None,
                 sync_threshold: float = 0.55, probe_blocks: int = 2,
                 drop_idle_blocks: int = 0, on_update=None,
                 on_change=None, compute_dtype: str = "f32",
                 afc: bool = False, use_pallas=None):
        self.n_bins = n_bins
        self.fs_chan = fs_chan
        self.fs_wide = n_bins * fs_chan
        self.block_len = block_len
        self.rescan_blocks = rescan_blocks
        self.min_snr_db = min_snr_db
        self.families = families
        self.sync_threshold = sync_threshold
        self.probe_blocks = max(1, probe_blocks)
        self.drop_idle_blocks = drop_idle_blocks
        self.on_update = on_update
        self.on_change = on_change          # callback(list[TrackedSonde])
        self.compute_dtype = compute_dtype
        self.afc = afc
        self.use_pallas = use_pallas

        self.tracked: List[TrackedSonde] = []
        self.blocks_seen = 0
        self.fleet: Optional[FleetSession] = None
        self._recent: List[np.ndarray] = []   # last wideband blocks (host)
        # carriers that failed classification (interference, unknown
        # protocols): remembered so they are not re-probed — and re-compiled
        # — every rescan; retried after retry_failed_blocks
        self._failed: List[Tuple[float, int]] = []   # (center_hz, block)
        self.retry_failed_blocks = 10 * rescan_blocks

    @property
    def telemetry(self) -> Dict[int, Tuple[str, SondeTelemetry]]:
        """Last-known telemetry keyed by tracked-sonde index."""
        return {i: (t.sonde, t.telem) for i, t in enumerate(self.tracked)
                if t.telem is not None}

    # -- internals ----------------------------------------------------------

    def _fleet_update(self, ch: int, sonde: str, telem: SondeTelemetry) -> None:
        if ch < len(self.tracked):
            self.tracked[ch].last_update_block = self.blocks_seen
            self.tracked[ch].telem = telem
        if self.on_update is not None:
            self.on_update(ch, sonde, telem)

    def _wrap_df(self, a: float, b: float) -> float:
        """Circular frequency distance (the wideband spectrum wraps at
        +/-fs_wide/2; a near-Nyquist carrier and its alias are the same)."""
        fs = self.fs_wide
        return abs((a - b + fs / 2.0) % fs - fs / 2.0)

    def _known(self, center_hz: float) -> bool:
        return any(self._wrap_df(t.center_hz, center_hz) < 0.25 * self.fs_chan
                   for t in self.tracked)

    def _recently_failed(self, center_hz: float) -> bool:
        self._failed = [(f, b) for f, b in self._failed
                        if self.blocks_seen - b <= self.retry_failed_blocks]
        return any(self._wrap_df(f, center_hz) < 0.25 * self.fs_chan
                   for f, _ in self._failed)

    def _rebuild(self) -> None:
        """Apply the current ``tracked`` list as the fleet's channel map,
        transplanting state for groups whose channel list is unchanged."""
        old_groups = self.fleet.groups if self.fleet is not None else {}
        old_channels = (self.fleet.channels if self.fleet is not None else [])

        # layout comes from the fixed discovery-time identity, NOT the
        # AFC-refreshed live center: state transplant and checkpoints
        # compare channel layouts exactly. But a group whose MEMBERSHIP
        # changed gets a fresh session anyway — re-seed its members'
        # identities from the live (drift-corrected) centers first, so the
        # new session starts tuned to where each carrier actually is now.
        old_layouts = {
            sonde: [(old_channels[j].pfb_bin, old_channels[j].offset_hz)
                    for j in idxs]
            for sonde, (idxs, _s) in old_groups.items()}
        if self.fleet is not None:     # not on first build / checkpoint
            members: Dict[str, List[TrackedSonde]] = {}
            for t in self.tracked:
                members.setdefault(t.sonde, []).append(t)
            from sondetpu.dsp.channelizer import bin_and_offset
            for sonde, ts in members.items():
                layout = [(t.pfb_bin, t.seed_offset_hz) for t in ts]
                if old_layouts.get(sonde) != layout:
                    for t in ts:
                        t.pfb_bin, t.seed_offset_hz = bin_and_offset(
                            t.center_hz, self.fs_chan, self.n_bins)
        chans = [FleetChannel(pfb_bin=t.pfb_bin, sonde=t.sonde,
                              offset_hz=t.seed_offset_hz)
                 for t in self.tracked]
        if not chans:
            self.fleet = None
            if self.on_change is not None:
                self.on_change([])
            return
        fleet = FleetSession(chans, n_bins=self.n_bins, fs_chan=self.fs_chan,
                             block_len=self.block_len,
                             sync_threshold=self.sync_threshold,
                             compute_dtype=self.compute_dtype, afc=self.afc,
                             use_pallas=self.use_pallas,
                             on_update=self._fleet_update)
        # reuse the old session (device + host state) for any sonde group
        # whose logical channels are IDENTICAL (same bins/offsets in the
        # same order) — the common case when a new type appears
        for sonde, (idxs, sess) in fleet.groups.items():
            if sonde not in old_groups:
                continue
            o_idxs, o_sess = old_groups[sonde]
            same = (len(idxs) == len(o_idxs) and all(
                (chans[i].pfb_bin, chans[i].offset_hz)
                == (old_channels[j].pfb_bin, old_channels[j].offset_hz)
                for i, j in zip(idxs, o_idxs)))
            if same:
                o_sess.on_update = fleet._wrap(sonde, idxs, self._fleet_update)
                fleet.groups[sonde] = (idxs, o_sess)
        if self.fleet is not None:
            fleet.pfb_state = self.fleet.pfb_state
        self.fleet = fleet
        if self.on_change is not None:
            self.on_change(list(self.tracked))

    def _refresh_centers(self) -> None:
        """Fold each channel's AFC-tracked offset back into its tracked
        center frequency, so a drifting transmitter keeps matching itself
        in later scans instead of re-appearing as a 'new' carrier."""
        if self.fleet is None or not self.afc:
            return
        for sonde, (idxs, sess) in self.fleet.groups.items():
            freqs = sess.afc_freqs
            if freqs is None:
                continue
            for local, fleet_ch in enumerate(idxs):
                t = self.tracked[fleet_ch]
                k = t.pfb_bin                   # fixed discovery identity
                f_bin = (k if k < self.n_bins / 2 else k - self.n_bins) \
                    * self.fs_chan
                center = f_bin + float(freqs[local])
                # wrap into [-fs_wide/2, fs_wide/2)
                t.center_hz = ((center + self.fs_wide / 2.0) % self.fs_wide
                               - self.fs_wide / 2.0)

    def _rescan(self) -> None:
        self._refresh_centers()
        # scan buffer entries are complex blocks or (i, q) plane pairs —
        # possibly MIXED if the caller switches input forms mid-run.
        # Normalize every entry to planes (complex entries split here, a
        # cheap view-copy) so the scan entry points get one plane tuple and
        # no full-buffer complex copy is ever materialized (for 1024-bin
        # blocks that copy was ~400 MB per buffered block).
        planes = [b if isinstance(b, tuple)
                  else (np.ascontiguousarray(b.real.astype(np.float32)),
                        np.ascontiguousarray(b.imag.astype(np.float32)))
                  for b in self._recent]
        wide = (np.concatenate([b[0] for b in planes]),
                np.concatenate([b[1] for b in planes]))
        carriers = detect_carriers(wide, self.fs_wide,
                                   min_snr_db=self.min_snr_db)
        fresh = [c for c in carriers if not self._known(c.center_hz)
                 and not self._recently_failed(c.center_hz)]
        changed = False
        if fresh:
            fresh = classify_carriers(
                wide, self.fs_wide, fresh, fs_chan=self.fs_chan,
                block_len=self.block_len, families=self.families,
                sync_threshold=self.sync_threshold)
            from sondetpu.dsp.channelizer import bin_and_offset
            for c in fresh:
                if c.sonde is not None:
                    k, resid = bin_and_offset(c.center_hz, self.fs_chan,
                                              self.n_bins)
                    self.tracked.append(TrackedSonde(
                        center_hz=c.center_hz, sonde=c.sonde,
                        pfb_bin=k, seed_offset_hz=resid,
                        last_update_block=self.blocks_seen,
                        found_block=self.blocks_seen))
                    changed = True
                else:
                    self._failed.append((c.center_hz, self.blocks_seen))
        if self.drop_idle_blocks:
            keep = [t for t in self.tracked
                    if self.blocks_seen - t.last_update_block
                    <= self.drop_idle_blocks]
            if len(keep) != len(self.tracked):
                self.tracked = keep
                changed = True
        if changed:
            self._rebuild()

    # -- public -------------------------------------------------------------

    def process_wideband(self, iq) -> int:
        """One wideband block: [n_bins * block_len] complex64 or an
        (i, q) float32 plane pair (the plane form avoids materializing a
        complex copy on the streaming hot path; complex is only rebuilt
        lazily when a rescan actually runs). Returns telemetry updates."""
        if isinstance(iq, tuple):
            pi, pq = iq
            # keep planes for the fleet; the scan buffer stores the pair
            # and _rescan combines lazily
            self._recent.append((np.asarray(pi), np.asarray(pq)))
            feed = (pi, pq)
        else:
            iq = np.asarray(iq)
            self._recent.append(iq)
            feed = iq
        if len(self._recent) > self.probe_blocks:
            self._recent.pop(0)
        updates = 0
        if self.fleet is not None:
            updates = self.fleet.process_wideband(feed)
        self.blocks_seen += 1
        # rescan on cadence; while the fleet is EMPTY scan every block once
        # the probe buffer fills (first acquisition should not wait out a
        # cadence) — the failed-classification cache bounds the cost when
        # the only emissions are unclassifiable
        if (self.rescan_blocks and self.blocks_seen % self.rescan_blocks == 0
                or (self.fleet is None
                    and len(self._recent) >= self.probe_blocks)):
            self._rescan()
        return updates
