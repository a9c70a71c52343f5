"""Mixed-fleet decoding: heterogeneous sonde types over one wideband input.

BASELINE.json:11 ("Mixed-fleet wideband: 1000+ heterogeneous channels"):
the reference handles multiple sondes by running one module instance per
sonde, each with its own VFO and threads (main.cpp:23); here ONE PFB
channelizer splits the wideband stream and channels are grouped by sonde
type, each group advancing through its type's compiled pipeline as a
batch. Each per-type step is an independent device program, so groups
pipeline naturally on the device queue.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from sondetpu.dsp.channelizer import PFBChannelizer
from sondetpu.runtime.pipeline import PipelineConfig
from sondetpu.sondes.base import get_sonde
from sondetpu.runtime.session import DecoderSession
from sondetpu.telemetry import SondeTelemetry


@dataclass
class FleetChannel:
    """One logical channel: which PFB bin, which protocol, and the fine
    frequency offset below the PFB grid (the reference VFO's free tuning,
    main.cpp:56)."""

    pfb_bin: int
    sonde: str
    offset_hz: float = 0.0


class FleetSession:
    """Wideband IQ -> channelize -> per-type batched decode sessions."""

    def __init__(self, channels: Sequence[FleetChannel], n_bins: int,
                 fs_chan: float = 48000.0, block_len: int = 48000,
                 sync_threshold: float = 0.55, use_pallas=None,
                 on_update=None, mesh=None, compute_dtype: str = "f32",
                 afc: bool = False, pipelined: bool = False,
                 fused: bool = None):
        import jax as _jax
        import jax.numpy as _jnp
        self.channels = list(channels)
        # bf16 fleets run the PFB itself in bf16 (it reads and writes the
        # whole wideband block); each group's pipeline then casts the
        # gathered planes to ITS compute dtype
        self.pfb = PFBChannelizer(
            n_bins, dtype="bf16" if compute_dtype == "bf16" else "f32")
        self.pfb_state = self.pfb.init_state()
        self.block_len = block_len
        self.n_bins = n_bins
        self.fs_chan = fs_chan
        # use_pallas: the fused dual-tone kernel for the groups whose
        # config runs the dual-tone front end (PipelineConfig.use_pallas;
        # None = wherever it compiles)
        self.use_pallas = use_pallas

        # group logical channels by sonde type; remember their PFB bins
        groups: Dict[str, List[int]] = {}
        for idx, ch in enumerate(self.channels):
            groups.setdefault(ch.sonde, []).append(idx)
        self.groups: Dict[str, Tuple[List[int], DecoderSession]] = {}
        self._group_pad: Dict[str, int] = {}
        for sonde, idxs in groups.items():
            offs = tuple(self.channels[i].offset_hz for i in idxs)
            spec = get_sonde(sonde)["spec"]
            # PAD each group of >= 64 channels with dummy channels
            # (duplicates of its first bin) to a 64-multiple; dummy rows
            # decode garbage that is discarded by the local-index guards in
            # _wrap/telemetry. The conv path's feature-group tiling
            # (_group_size) wants a large divisor: a real mix's sizes
            # (1230, 614, 204) have divisors 2..4 only. Mesh fleets skip
            # padding (sizes must divide the mesh).
            if mesh is None and len(idxs) >= 64:
                pad = (-len(idxs)) % 64
            else:
                pad = 0
            self._group_pad[sonde] = pad
            offs_p = offs + (0.0,) * pad
            # bf16 applies per group: AFSK groups fall back to f32
            group_cdt = "f32" if spec.modulation == "afsk" else compute_dtype
            # the kernel knob reaches the dual-tone families only (a config
            # that cannot host the kernel raises when it is forced)
            group_pallas = (use_pallas if spec.extra.get("fsk_dualtone")
                            else False)
            # afc applies per group (AFSK included: the discriminator-DC
            # loop tracks carrier offset for tone pairs too — pipeline.py);
            # the dual-tone kernel exports the rotation sums the loop feeds on
            group_afc = afc
            cfg = PipelineConfig(sonde=sonde, channels=len(idxs) + pad,
                                 fs=fs_chan, block_len=block_len,
                                 sync_threshold=sync_threshold,
                                 use_pallas=group_pallas,
                                 compute_dtype=group_cdt,
                                 afc=group_afc,
                                 fine_offsets=offs_p if any(offs_p) else None)
            # shard a group over the mesh when its channel count divides the
            # mesh size; smaller groups stay single-device (heterogeneous
            # fleets mix both, BASELINE.json:11)
            group_mesh = mesh if (mesh is not None
                                  and len(idxs) % mesh.devices.size == 0) else None
            # pipelined groups: every group's next step is dispatched before
            # any packed readback, so the readbacks of block
            # k overlap the device's block k+1 across ALL groups
            sess = DecoderSession(cfg, on_update=self._wrap(sonde, idxs, on_update),
                                  mesh=group_mesh, pipelined=pipelined)
            self.groups[sonde] = (idxs, sess)
        # per-group device-side bin gathers: the channelized planes never
        # round-trip through the host (the PFB output stays device-resident
        # and each group takes its rows with a baked-constant jnp.take)
        self._gathers = {}
        for sonde, (idxs, _sess) in self.groups.items():
            bins = self._group_bins(sonde, idxs)

            def take(yi, yq, _b=bins):
                k = _jnp.asarray(_b)
                return _jnp.take(yi, k, axis=0), _jnp.take(yq, k, axis=0)

            self._gathers[sonde] = _jax.jit(take)

        # FUSED fleet step: PFB + every group's bin gather + every group's
        # front end traced into ONE device program, with all groups' packed
        # outputs concatenated into ONE flat readback buffer (the unfused
        # path costs ~(1 + 2 * n_groups) dispatches and n_groups
        # synchronizing readbacks per block). With pipelined=True the fused
        # readback additionally overlaps the next block's compute (updates
        # then lag one block; pipelined=False keeps same-block updates and
        # reads back synchronously).
        if fused is None:
            fused = True
        # single-process, no mesh: the flat fused step below. With a mesh
        # (single- OR multi-process), the fused MESH step (one global jit
        # per block; GSPMD shards the group states/outputs over the mesh
        # and inserts the yi->channel collectives).
        self._fused = bool(fused) and mesh is None
        self._fused_mesh = bool(fused) and mesh is not None
        self.mesh = mesh
        self.pipelined = bool(pipelined)
        self._pending = None
        if self._fused_mesh:
            self._build_fused_mesh(mesh)
        if self._fused:
            self._order = []                      # [(sonde, bins, sess)]
            for sonde, (idxs, sess) in self.groups.items():
                self._order.append((sonde, self._group_bins(sonde, idxs),
                                    sess))
            pfb = self.pfb

            def fused_impl(pfb_state, states, wi, wq):
                pfb_state, yi, yq = pfb._impl(pfb_state, wi, wq)
                new_states, packeds, frames = [], [], []
                for (sonde, bins, sess), st in zip(self._order, states):
                    k = _jnp.asarray(bins)
                    # planes flow in the PFB's dtype (bf16 on bf16
                    # fleets); each group's _step_impl casts to its own
                    # compute dtype (f32 for AFSK groups)
                    gi = _jnp.take(yi, k, axis=0)
                    gq = _jnp.take(yq, k, axis=0)
                    st2, out = sess.pipeline._step_impl(st, gi, gq)
                    new_states.append(st2)
                    packeds.append(out.packed)
                    frames.append(out.frames)
                return (pfb_state, tuple(new_states),
                        _jnp.concatenate(packeds), tuple(frames))

            self._fused_step = _jax.jit(fused_impl, donate_argnums=(0, 1))
            self._states = tuple(sess.state for _, _, sess in self._order)

    def _build_fused_mesh(self, mesh) -> None:
        """One global jitted program per block for a mesh fleet: PFB +
        every mesh-sharded group's bin gather + front end, with GSPMD
        placing the channelized-row -> sharded-channel movement on the
        interconnect. Groups whose channel count doesn't divide the mesh
        stay per-process (their gathers run on the returned replicated
        planes). State layout note: leaves shard on their leading axis as
        a LAYOUT choice (semantics stay global), so zero-init states are
        always correct; restoring a single-device checkpoint into a mesh
        fleet goes through the same host arrays and stays correct too."""
        import jax as _jax
        import jax.numpy as _jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from sondetpu.parallel.sharding import (constrain_channels,
                                                mesh_channel_axes,
                                                shard_channels)

        axis = mesh_channel_axes(mesh)
        self._mp_order = []        # mesh-sharded groups: (sonde, bins, sess)
        self._mp_local = []        # indivisible groups: per-process decode
        for sonde, (idxs, sess) in self.groups.items():
            bins = self._group_bins(sonde, idxs)
            if sess.mesh is not None:
                self._mp_order.append((sonde, bins, sess))
            else:
                self._mp_local.append(sonde)
        pfb = self.pfb
        repl = NamedSharding(mesh, P())

        def impl(pfb_state, states, wi, wq):
            pfb_state, yi, yq = pfb._impl(pfb_state, wi, wq)
            new_states, outs = [], []
            for (sonde, bins, sess), st in zip(self._mp_order, states):
                k = _jnp.asarray(bins)
                gi = _jnp.take(yi, k, axis=0)
                gq = _jnp.take(yq, k, axis=0)
                # constrain the gathered planes to the group's channel
                # sharding: GSPMD then owns the row movement
                gi, gq = constrain_channels((gi, gq), mesh, axis)
                st2, out = sess.pipeline._step_impl(st, gi, gq)
                new_states.append(constrain_channels(st2, mesh, axis))
                outs.append((out.packed, out.frames))
            pfb_state = _jax.lax.with_sharding_constraint(pfb_state, repl)
            return pfb_state, tuple(new_states), tuple(outs), yi, yq

        self._mp_step = _jax.jit(impl, donate_argnums=(0, 1))
        self._mp_shard = lambda tree: shard_channels(tree, mesh, axis)
        # PFB state + wideband planes are replicated over the mesh (every
        # chip sees the SDR stream; in an N-process run each process
        # materializes copies for its local devices)
        # DecoderSession(mesh=...) already sharded each mesh group's state
        # over the mesh in its constructor; nothing to re-place here
        self._mp_repl = repl

    def _replicate(self, x):
        """Host array -> mesh-replicated global device array."""
        import jax as _jax
        if _jax.process_count() == 1:
            return _jax.device_put(x, self._mp_repl)
        arr = np.asarray(x)
        return _jax.make_array_from_callback(
            arr.shape, self._mp_repl, lambda idx, _a=arr: _a[idx])

    def _process_wideband_mesh(self, wi, wq) -> int:
        """Fused mesh-fleet block: ONE executable per process covering the
        PFB and every mesh group; indivisible groups decode per-process on
        the returned replicated planes."""
        import time as _time
        from sondetpu.runtime.pipeline import BlockOutput

        wi = self._replicate(wi)
        wq = self._replicate(wq)
        if not isinstance(self.pfb_state.tail_i, __import__("jax").Array) \
                or self.pfb_state.tail_i.sharding != self._mp_repl:
            self.pfb_state = type(self.pfb_state)(
                tail_i=self._replicate(self.pfb_state.tail_i),
                tail_q=self._replicate(self.pfb_state.tail_q))
        states = tuple(sess.state for _, _, sess in self._mp_order)
        self.pfb_state, new_states, outs, yi, yq = self._mp_step(
            self.pfb_state, states, wi, wq)
        updates = 0
        for (sonde, bins, sess), st, (packed, frames) in zip(
                self._mp_order, new_states, outs):
            sess.state = st
            t0 = _time.perf_counter()
            out = BlockOutput(frames=frames, frame_valid=None,
                              frame_score=None, soft_rms=None,
                              rs_clean=None, packed=packed)
            sess.blocks_seen += 1
            ups, frames_raw, decoded, soft_rms = sess._handle_output(out)
            sess.metrics.on_block(sess.config.block_len,
                                  _time.perf_counter() - t0,
                                  frames_raw, decoded, len(ups), soft_rms)
            updates += len(ups)
        for sonde in self._mp_local:
            idxs, sess = self.groups[sonde]
            gi, gq = self._gathers[sonde](yi, yq)
            updates += len(sess.process_block((gi, gq)))
        return updates

    def _group_bins(self, sonde: str, idxs: List[int]) -> np.ndarray:
        """PFB bin indices a group gathers, padded with duplicates of its
        first bin for the dummy kernel-tile channels (_group_pad)."""
        bins = [self.channels[i].pfb_bin for i in idxs]
        bins += [bins[0]] * self._group_pad.get(sonde, 0)
        return np.asarray(bins, np.int32)

    def _wrap(self, sonde: str, idxs: List[int], on_update):
        if on_update is None:
            return None

        def inner(local_ch: int, telem: SondeTelemetry):
            if local_ch < len(idxs):       # dummy pad channels are dropped
                on_update(idxs[local_ch], sonde, telem)

        return inner

    @property
    def telemetry(self) -> Dict[int, SondeTelemetry]:
        """Telemetry keyed by logical (fleet) channel index."""
        out = {}
        for sonde, (idxs, sess) in self.groups.items():
            for local, t in sess.telemetry.items():
                if local < len(idxs):      # dummy pad channels are dropped
                    out[idxs[local]] = t
        return out

    def flush(self) -> int:
        """Drain every pipelined group's pending block (call at end of
        stream — without it the final block's frames are dropped)."""
        if self._fused:
            pending, self._pending = self._pending, None
            return self._consume(pending) if pending is not None else 0
        return sum(len(sess.flush()) for _, sess in self.groups.values())

    def _consume(self, pending) -> int:
        """Read one fused block's concatenated packed buffer (ONE device ->
        host transfer for the whole fleet) and run every group's host-side
        FEC/parse/merge on its slice."""
        import time as _time
        packed_all, frames = pending
        host = np.asarray(packed_all)
        updates = 0
        off = 0
        for (sonde, bins, sess), frames_k in zip(self._order, frames):
            t0 = _time.perf_counter()
            c = sess.config
            nbytes = c.channels * c.packed_row_bytes
            from sondetpu.runtime.pipeline import BlockOutput
            out = BlockOutput(frames=frames_k, frame_valid=None,
                              frame_score=None, soft_rms=None, rs_clean=None,
                              packed=host[off:off + nbytes])
            off += nbytes
            sess.blocks_seen += 1
            ups, frames_raw, decoded, soft_rms = sess._handle_output(out)
            sess.metrics.on_block(c.block_len, _time.perf_counter() - t0,
                                  frames_raw, decoded, len(ups), soft_rms)
            updates += len(ups)
        return updates

    def process_wideband(self, iq: np.ndarray) -> int:
        """One wideband block [n_bins * block_len] complex64 (or plane
        pair). Returns total telemetry updates."""
        if isinstance(iq, tuple):
            wi, wq = iq
        else:
            from sondetpu.io.iq import c64_to_planes
            wi, wq = c64_to_planes(np.asarray(iq))   # native deinterleaver
        if self._fused_mesh:
            return self._process_wideband_mesh(wi, wq)
        if self._fused:
            # read each group's CURRENT session state (not a cached tuple):
            # a reset_channel / checkpoint-restore between blocks replaces
            # sess.state, and the fused step must see the replacement
            self._states = tuple(sess.state for _, _, sess in self._order)
            self.pfb_state, self._states, packed_all, frames = \
                self._fused_step(self.pfb_state, self._states, wi, wq)
            # sessions see their live state (checkpoint/afc introspection)
            for (sonde, bins, sess), st in zip(self._order, self._states):
                sess.state = st
            if not self.pipelined:
                return self._consume((packed_all, frames))
            # pipelined: block k's readback overlaps the
            # device's block k+1 — updates lag the input by one block
            pending, self._pending = self._pending, (packed_all, frames)
            return self._consume(pending) if pending is not None else 0
        self.pfb_state, yi, yq = self.pfb(self.pfb_state, wi, wq)
        # yi/yq stay ON DEVICE: each group's rows are gathered device-side
        # and fed straight into its compiled step — the only host transfer
        # per block is each group's packed frame readback
        updates = 0
        for sonde, (idxs, sess) in self.groups.items():
            # N>=2 processes: the PFB runs process-locally (every process
            # ingests the same wideband stream); shard_channels assembles
            # the cross-process global array from these local DEVICE
            # planes with make_array_from_single_device_arrays — the
            # channelized samples never round-trip through the host
            gi, gq = self._gathers[sonde](yi, yq)
            updates += len(sess.process_block((gi, gq)))
        return updates
