"""Host-side decode session: device pipeline driver + telemetry aggregation.

Plays the role of the reference's decoder adapter + module glue
(decoder.hpp:53-119 run loop and main.cpp:321-331 sondeDataHandler): pulls
framed bytes off the device, runs byte-level FEC/parse, merges fragments
into per-channel running telemetry, and fans out to sinks (GPX/PTU/JSONL).

Also carries the aux-subsystem duties the reference lacks (SURVEY.md §5):
metrics counters (§5.1/§5.5), per-channel failure detection + elastic
recovery via the stale-channel watchdog (§5.3), and checkpoint/resume hooks
(§5.4 via runtime/checkpoint.py).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from sondetpu.runtime.metrics import Metrics
from sondetpu.runtime.pipeline import BlockOutput, Pipeline, PipelineConfig
from sondetpu.sondes.base import get_sonde
from sondetpu.telemetry import SondeTelemetry


class DecoderSession:
    """Streaming decode of [channels, block] IQ into telemetry updates."""

    def __init__(self, config: PipelineConfig,
                 on_update: Optional[Callable[[int, SondeTelemetry], None]] = None,
                 pipelined: bool = False, mesh=None, host_workers: int = 0,
                 pipeline: Optional[Pipeline] = None):
        self.config = config
        # callers that already hold a compiled Pipeline for this config
        # (bench.py's decode verification) reuse it instead of paying a
        # second construction + device-state allocation
        self.pipeline = (pipeline if pipeline is not None
                         else Pipeline(config, mesh=mesh))
        self.state = self.pipeline.init_state()
        # multi-chip: shard the channel axis of state + IQ over the mesh and
        # run the step SPMD (SURVEY.md §2.4 channel parallelism). Channels
        # must divide by the mesh size.
        self.mesh = mesh
        self._shard_fn = None
        self._sharded_step = None
        if mesh is not None:
            from sondetpu.parallel.sharding import sharded_pipeline_step
            self._sharded_step, self._shard_fn = sharded_pipeline_step(
                self.pipeline, mesh)
            self.state = self._shard_fn(self.state)
        self.decoder = get_sonde(config.sonde)["decoder"]()
        self.telemetry: Dict[int, SondeTelemetry] = {}
        self.on_update = on_update
        self.frames_seen = 0
        self.blocks_seen = 0
        self.metrics = Metrics(channels=config.channels, fs=config.fs)
        self._last_update_block: Dict[int, int] = {}
        # pipelined mode: dispatch block k+1 before reading block k's output
        # — the host readback overlaps the device's next step (the batched
        # analogue of the reference's per-block worker threads, SURVEY.md C2).
        # Telemetry updates then lag the input by one block.
        self.pipelined = pipelined
        self._pending = None
        # host_workers > 1: byte-level FEC/parse is sharded across a thread
        # pool on CHANNEL-ALIGNED row ranges — each worker touches a disjoint
        # set of channels, so the decoder's per-channel state (calibration
        # accumulators) is single-writer; the numpy-vectorized parse releases
        # the GIL, so threads scale it (the reference scales host decode the
        # same way: one thread per decoder block, SURVEY.md C2)
        self.host_workers = int(host_workers)
        self._pool = None
        if self.host_workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self.host_workers)

    @property
    def afc_freqs(self):
        """Per-channel AFC-tracked carrier offsets in Hz ([C] float32), or
        None when config.afc is off. The live analogue of where the human
        would have re-dragged each VFO (main.cpp:55-56)."""
        if not self.config.afc:
            return None
        return np.asarray(self.state.aux[-1])

    def reset_channel(self, channel: int) -> None:
        """Drop a channel's host state (elastic recovery, SURVEY.md §5.3);
        device state re-syncs on the next frames by itself (syncword
        re-acquisition is the protocol's own elasticity) — EXCEPT the
        AFC-tracked DDC frequency: a loop that mis-tracked to its clamp
        would hand the old sonde's offset to the next sonde on this
        channel, so the channel's row of state.aux[-1] is reseeded to its
        fine_offsets seed."""
        self.decoder.reset_channel(channel)
        self.telemetry.pop(channel, None)
        self._last_update_block.pop(channel, None)
        if self.config.afc:
            import jax
            freqs = self.state.aux[-1]
            if isinstance(freqs, jax.Array) and not freqs.is_fully_addressable:
                return   # multi-process: only the owning process reseeds
                         # (its own watchdog fires for its local channels)
            freqs = np.asarray(freqs).copy()
            seed = (np.float32(self.config.fine_offsets[channel])
                    if self.config.fine_offsets is not None
                    else np.float32(0.0))
            freqs[channel] = seed
            new_aux = self.state.aux[:-1] + (freqs,)
            self.state = self.state._replace(aux=new_aux)
            if self._shard_fn is not None:
                self.state = self._shard_fn(self.state)

    def watchdog(self, max_idle_blocks: int) -> List[int]:
        """Reset channels that produced no telemetry for max_idle_blocks.

        Returns the channels reset. A channel whose sonde drifted away or
        died keeps stale calibration/telemetry otherwise; this is the
        framework's failure-detection hook (SURVEY.md §5.3)."""
        stale = [ch for ch, blk in self._last_update_block.items()
                 if self.blocks_seen - blk > max_idle_blocks]
        for ch in stale:
            self.reset_channel(ch)
        return stale

    def process_block(self, iq) -> List[Tuple[int, SondeTelemetry]]:
        """iq: [channels, block_len] complex64 or (i, q) float32 planes.
        Returns (channel, telemetry snapshot) updates (for the previous
        block when ``pipelined``)."""
        t0 = time.perf_counter()
        if self.mesh is not None:
            if isinstance(iq, tuple):
                pi, pq = iq
            else:
                from sondetpu.io.iq import c64_to_planes
                pi, pq = c64_to_planes(np.asarray(iq))
            # device_put reshards device-resident planes (fleet PFB output)
            # without a host round-trip; host arrays upload sharded
            self.state, out = self._sharded_step(
                self.state, self._shard_fn(pi), self._shard_fn(pq))
        else:
            self.state, out = self.pipeline.step(self.state, iq)
        self.blocks_seen += 1
        if self.pipelined:
            out, self._pending = self._pending, out
            if out is None:
                self.metrics.on_block(self.config.block_len,
                                      time.perf_counter() - t0, 0, 0, 0)
                return []
        updates, frames_raw, decoded, soft_rms = self._handle_output(out)
        self.metrics.on_block(
            n_samples_per_chan=self.config.block_len,
            wall_seconds=time.perf_counter() - t0,
            frames_raw=frames_raw, frames_decoded=decoded,
            updates=len(updates), soft_rms=soft_rms)
        return updates

    def flush(self) -> List[Tuple[int, SondeTelemetry]]:
        """Drain the pending block in pipelined mode (call at end of stream)."""
        if not self.pipelined or self._pending is None:
            return []
        out, self._pending = self._pending, None
        updates, frames_raw, decoded, soft_rms = self._handle_output(out)
        self.metrics.on_block(0, 0.0, frames_raw, decoded, len(updates),
                              soft_rms)
        return updates

    def _packed_parts(self, out: BlockOutput):
        """Host copies of the packed buffer as (channel_base, bytes) parts.

        Single-process (incl. the virtual CPU mesh): ONE device->host
        transfer of the whole buffer. In an N>=2-process run the global
        array is not host-addressable — each process reads only ITS
        addressable channel shards and decodes those channels; telemetry
        crosses hosts via parallel/fanin.py, never raw sample data."""
        import jax
        packed_dev = out.packed
        if isinstance(packed_dev, jax.Array) and not packed_dev.is_fully_addressable:
            c = self.config
            row = c.packed_row_bytes
            parts = []
            seen = set()
            for sh in sorted(packed_dev.addressable_shards,
                             key=lambda s: (s.index[0].start or 0)):
                start = sh.index[0].start or 0
                if start in seen:          # replicated copy of a shard
                    continue
                seen.add(start)
                parts.append((start // row, np.asarray(sh.data)))
            # merge adjacent shards (contiguous per process) into one part
            merged = []
            for base, data in parts:
                if merged and merged[-1][0] + merged[-1][1].size // row == base:
                    merged[-1] = (merged[-1][0],
                                  np.concatenate([merged[-1][1], data]))
                else:
                    merged.append((base, data))
            return merged
        return [(0, np.asarray(packed_dev))]

    def local_channels(self) -> List[int]:
        """Global channel indices whose state/output this process holds
        (all channels in a single-process run). Derived from the state's
        actual sharding, not from an assumed contiguous-slab layout — a
        permuted device order or ('chip','host') axis order changes which
        rows a process owns."""
        import jax
        leaf = getattr(self.state, "chipbuf", None)
        if (self.mesh is None or not isinstance(leaf, jax.Array)
                or leaf.is_fully_addressable):
            return list(range(self.config.channels))
        chans = set()
        for sh in leaf.addressable_shards:
            sl = sh.index[0]
            stop = self.config.channels if sl.stop is None else sl.stop
            chans.update(range(sl.start or 0, stop))
        return sorted(chans)

    def _handle_output(self, out: BlockOutput):
        from sondetpu.runtime.pipeline import unpack_block_output
        updates: List[Tuple[int, SondeTelemetry]] = []
        frames_total = 0
        frags_total = 0
        # full-length quality vector: consumers (CLI table, metrics) index
        # it by GLOBAL channel id, so multi-process parts land at their
        # channel base (non-local channels read 0)
        soft_rms = np.zeros(self.config.channels, np.float32)
        for ch_base, packed in self._packed_parts(out):
            res = unpack_block_output(packed, self.config.k_slots,
                                      self.config.wire_ncols,
                                      self.config.chase_total)
            weak_all = None
            if self.config.chase_m:
                all_frames, valid, rs_clean, part_rms, weak_all = res
            else:
                all_frames, valid, rs_clean, part_rms = res
            soft_rms[ch_base:ch_base + part_rms.size] = part_rms
            if not valid.any():
                continue
            ch_idx, slot_idx = np.nonzero(valid)
            frames = all_frames[ch_idx, slot_idx]             # [n, wire_ncols]
            ch_idx = ch_idx + ch_base                         # global channels
            self.frames_seen += frames.shape[0]
            frames_total += int(frames.shape[0])
            clean = rs_clean[ch_idx - ch_base, slot_idx]
            cols = self.config.wire_columns
            # compact mode: prefetch suspect full frames in ONE device gather
            # so workers stay pure-numpy
            full = None
            sus_ord = None
            if cols is not None:
                suspect = ~clean
                if suspect.any():
                    full = self._fetch_full(out, ch_idx[suspect],
                                            slot_idx[suspect])
                    sus_ord = np.cumsum(suspect) - 1
            if weak_all is not None and getattr(self.decoder,
                                                "wants_weak_bits", False):
                # soft-assist families: hand the device's weakest-bit ranks
                # to the Chase repair in the host parser
                frags = self.decoder.decode_byte_frames(
                    frames, ch_idx,
                    weak_bits=weak_all[ch_idx - ch_base, slot_idx])
            elif self._pool is not None and ch_idx.size >= 4 * self.host_workers:
                frags = self._decode_parallel(frames, ch_idx, clean, cols,
                                              full, sus_ord)
            elif cols is not None:
                frags = self._decode_rows(frames, ch_idx, clean, cols,
                                          full, sus_ord, 0)
            # frames arrive as descrambled bytes (packed + de-whitened on
            # device); decoders that understand the device RS-syndrome
            # verdict skip host FEC for clean frames
            elif getattr(self.decoder, "wants_rs_clean", False):
                frags = self.decoder.decode_byte_frames(frames, ch_idx,
                                                        rs_clean=clean)
            else:
                frags = self.decoder.decode_byte_frames(frames, ch_idx)
            frags_total += len(frags)
            updates += self._merge_frags(frags)
        return updates, frames_total, frags_total, soft_rms

    def _fetch_full(self, out: BlockOutput, ch_idx, slot_idx) -> np.ndarray:
        """Suspect full-frame fetch; in an N>=2-process run the frames
        array is not globally addressable, so the rows come from this
        process's own shards (the requested channels are local by
        construction of the packed-part readback)."""
        import jax
        frames_dev = out.frames
        if isinstance(frames_dev, jax.Array) and not frames_dev.is_fully_addressable:
            fb = self.config.spec.frame_bytes
            res = np.zeros((len(ch_idx), fb), np.uint8)
            shards = [((s.index[0].start or 0),
                       self.config.channels if s.index[0].stop is None
                       else s.index[0].stop, s.data)
                      for s in frames_dev.addressable_shards]
            for i, (c, k) in enumerate(zip(ch_idx, slot_idx)):
                for start, stop, data in shards:
                    if start <= c < stop:
                        res[i] = np.asarray(data[int(c - start), int(k)])
                        break
            return res
        return self.pipeline.fetch_frames(frames_dev, ch_idx, slot_idx)

    def telemetry_fanin(self, cap: Optional[int] = None) -> dict:
        """All-process telemetry view: gather every process's numeric
        telemetry rows over the fleet's collectives (SURVEY.md §5.8
        all_gather) -> {channel: {field: value}} on EVERY process. The
        single-process form is just this session's telemetry.

        The wire cap defaults to this session's channel count (every
        process runs the same config, so the collective shape agrees) — no
        channel can silently drop from the cross-host view."""
        from sondetpu.parallel import fanin
        if cap is None:
            cap = max(1, self.config.channels)
        rows = fanin.telemetry_rows(self.telemetry)
        return fanin.rows_to_dict(fanin.allgather_rows(rows, cap=cap))

    def metrics_fanin(self) -> dict:
        """Cluster-wide counter sums (the psum of SURVEY.md §5.8)."""
        from sondetpu.parallel import fanin
        m = self.metrics
        tot = fanin.sum_counts([self.frames_seen, m.frames_decoded,
                                m.updates, self.blocks_seen])
        return {"frames_raw": int(tot[0]), "frames_decoded": int(tot[1]),
                "updates": int(tot[2]),
                "blocks": int(tot[3] // max(1, __import__("jax").process_count()))}

    def _merge_frags(self, frags) -> List[Tuple[int, SondeTelemetry]]:
        updates: List[Tuple[int, SondeTelemetry]] = []
        telemetry = self.telemetry
        blocks_seen = self.blocks_seen
        last_update = self._last_update_block
        on_update = self.on_update
        for ch, frag in frags:
            ch = int(ch)
            telem = telemetry.get(ch)
            if telem is None:
                telem = telemetry[ch] = SondeTelemetry()
            if telem.merge(frag):
                last_update[ch] = blocks_seen
                # snapshot: the live object keeps mutating on later frames
                snap = telem.snapshot()
                updates.append((ch, snap))
                if on_update:
                    on_update(ch, snap)
        return updates

    def _decode_rows(self, wire: np.ndarray, ch: np.ndarray,
                     clean: np.ndarray, cols: np.ndarray,
                     full: Optional[np.ndarray], sus_ord: Optional[np.ndarray],
                     row0: int):
        """Compact wire-column readback (spec.extra['wire_columns']) for one
        row range [row0, row0+len): RS-clean frames are reconstructed
        column-sparse and parsed without CRC re-checks (the device syndrome
        already proves integrity); suspect frames use the prefetched full
        gather ``full`` (``sus_ord`` maps global row -> row of full)."""
        fb = self.config.spec.frame_bytes
        frags = []
        if clean.any():
            recon = np.zeros((int(clean.sum()), fb), np.uint8)
            recon[:, np.asarray(cols)] = wire[clean]
            frags += self.decoder.decode_byte_frames(
                recon, ch[clean], rs_clean=np.ones(recon.shape[0], bool),
                crc_present=False)
        suspect = ~clean
        if suspect.any():
            rows = np.nonzero(suspect)[0] + row0
            frags += self.decoder.decode_byte_frames(
                full[sus_ord[rows]], ch[suspect],
                rs_clean=np.zeros(int(suspect.sum()), bool))
        return frags

    def _decode_parallel(self, frames: np.ndarray, ch_idx: np.ndarray,
                         clean: np.ndarray, cols, full, sus_ord):
        """Shard the byte-level decode over the thread pool on channel-
        aligned row ranges (ch_idx is sorted: np.nonzero row order)."""
        n = ch_idx.size
        w = self.host_workers
        bounds = [0]
        for k in range(1, w):
            p = k * n // w
            while 0 < p < n and ch_idx[p] == ch_idx[p - 1]:
                p += 1                  # never split a channel across workers
            bounds.append(p)
        bounds.append(n)
        ranges = [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]

        def work(ab):
            a, b = ab
            sl = slice(a, b)
            if cols is not None:
                return self._decode_rows(frames[sl], ch_idx[sl], clean[sl],
                                         cols, full, sus_ord, a)
            if getattr(self.decoder, "wants_rs_clean", False):
                return self.decoder.decode_byte_frames(
                    frames[sl], ch_idx[sl], rs_clean=clean[sl])
            return self.decoder.decode_byte_frames(frames[sl], ch_idx[sl])

        return [f for r in self._pool.map(work, ranges) for f in r]
