"""The per-block decoding pipeline: batched IQ in, framed chips out.

Fuses the reference's L2-L4 thread chain (VFO -> FM demod -> resampler ->
sondedump decoder, src/main.cpp:55-68) into ONE jitted device program over a
channel axis (BASELINE.json:5): FM discriminate, matched-filter, recover
symbol timing, slice, ring-buffer chips, correlate the syncword, and gather
complete frames into fixed-capacity slots. Byte-level work (FEC + parse)
happens host-side on the tiny framed output (SURVEY.md §7 "decide by
measuring").

Carry-over state is an explicit pytree (SURVEY.md §5.7): chunked processing
of a stream equals processing it unchunked, which tests/test_pipeline.py
asserts.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from sondetpu.dsp.fir import FIRState, _apply_windows, design_lowpass
from sondetpu.sync.coding import biphase_m_decode, manchester_decode
from sondetpu.sync.correlator import (
    correlate_syncword, find_frame_starts, gather_frames)
from sondetpu.sync.timing import TimingState, oerder_meyr_tau
from sondetpu.sondes.base import get_sonde


@dataclass(frozen=True)
class PipelineConfig:
    """Static compile-time parameters of a per-type chain."""

    sonde: str = "rs41"
    channels: int = 8
    fs: float = 48000.0            # channel IQ sample rate
    block_len: int = 48000         # IQ samples per step (1 s)
    max_frames: Optional[int] = None  # frame slots per channel per block;
                                   # None = auto (just enough for the block)
    sync_threshold: float = 0.6    # normalized correlation acceptance
    ntaps: int = 41                # matched/lowpass filter taps
    dc_block: bool = True          # remove residual carrier offset per block
    # the fused dual-tone front-end kernel (sondetpu/pallas/dualtone.py):
    # None = the kernel where it compiles (a dual-tone family at decim 1 on
    # a GPU), else the jnp path; False = the jnp path; True = the kernel
    # compiled for the GPU; "interpret" = the kernel in the Pallas
    # interpreter (tests on the CPU). True/"interpret" for a family the
    # kernel cannot serve raise.
    use_pallas: object = None
    # per-channel fine frequency offsets (Hz), length == channels: digital
    # downconversion below the PFB grid — the analogue of the reference
    # VFO's free tuning with 1 kHz snap (main.cpp:56). None = all on-grid.
    fine_offsets: Optional[tuple] = None
    # automatic frequency control: the DDC frequency becomes per-channel
    # STATE, nudged each block by the FM discriminator's DC (mean audio of
    # 1.0 == spec.dev Hz of residual carrier offset). Tracks transmitter
    # drift the reference handles by the human re-dragging the VFO on the
    # waterfall (main.cpp:55-56). fine_offsets (or zeros) seed the loop.
    afc: bool = False
    afc_beta: float = 0.5          # per-block loop gain (0 < beta <= 1)
    afc_max_hz: Optional[float] = None   # clamp; default spec.bandwidth/2
    # input plane dtype: "f32" (default), or "i16"/"i8" — raw SDR sample
    # planes (cs16/cs8 sources) upload as integers and dequantize ON DEVICE,
    # cutting host->device transfer 2x/4x (the reference converts to float
    # on the host because its DSP chain is host-side; ours isn't)
    input_dtype: str = "f32"
    # on-device storage dtype for the sample-rate arrays (IQ planes,
    # filtered audio, soft chips): "bf16" halves the HBM traffic of the
    # memory-bound convs; every reduction/accumulation (conv accumulators,
    # timing estimate, correlation) stays float32. bf16's ~0.4% relative
    # quantization sits ~40 dB under the signal — far below the noise at
    # any decodable SNR (FER tests assert parity). GFSK/FSK families only.
    compute_dtype: str = "f32"
    # profiling ablation: truncate the compiled step after the named stage
    # ("chanfilt"|"demod"|"timing"|"sample"|"corr"|"peaks"|"gather"|
    # "syndrome") and return only a checksum scalar. Stage-by-stage timing
    # differences give per-stage device cost (tools/profile_stages.py).
    profile_stop: Optional[str] = None

    def __post_init__(self):
        if self.input_dtype not in ("f32", "i16", "i8"):
            raise ValueError(f"input_dtype {self.input_dtype!r}")
        if self.ntaps % 2 == 0:
            raise ValueError("ntaps must be odd (carry widths derive "
                             "from it)")
        if self.compute_dtype not in ("f32", "bf16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.use_pallas not in (None, False, True, "interpret"):
            raise ValueError(f"use_pallas {self.use_pallas!r}")
        spec = get_sonde(self.sonde)["spec"]
        if self.compute_dtype == "bf16" and spec.modulation == "afsk":
            raise ValueError("bf16 compute supports the GFSK/FSK paths only")
        # AFSK families track carrier drift with the SAME discriminator-DC
        # loop: the Bell-202 audio is a pair of (near) zero-mean tones, so
        # the block mean of the discriminator output measures carrier
        # offset with only a small partial-cycle data residue (the space
        # tone's 1.83 cycles/symbol truncation) — bounded well below the
        # loop's clamp and averaged down over the block. Verified by the
        # drifting-iMet-4 test (tests/test_afc.py).
        sps = self.fs / spec.baud
        if abs(self.block_len / sps - round(self.block_len / sps)) > 1e-9:
            raise ValueError("block_len must be an integer number of symbols")
        if self.use_pallas and not (self.dualtone and self.decim == 1):
            # the kernel implements the dual-tone front end alone; a family
            # it cannot serve must not silently run another path
            raise ValueError(f"{self.sonde}: the fused kernel serves only "
                             "the dual-tone FSK front end at decim 1")

    @property
    def spec(self):
        return get_sonde(self.sonde)["spec"]

    @property
    def decim(self) -> int:
        """Decimation fused into the pre-demod channel filter.

        Narrowband types (channel bandwidth well below the half-rate
        Nyquist and >= 4 samples/symbol after decimation) process the
        demod/timing/slicing chain at fs/2 — the channel filter's strided
        conv halves every downstream stage's cost. AFSK needs the full
        audio bandwidth for its tones, so it stays at fs.
        """
        spec = self.spec
        if (spec.modulation != "afsk"
                and self.fs / 2.0 >= 2.2 * spec.bandwidth
                and (self.fs / 2.0) / spec.baud >= 4.0
                and self.block_len % 2 == 0):
            return 2
        return 1

    @property
    def dualtone(self) -> bool:
        """Whether this config runs the noncoherent dual-tone FSK front end
        (spec extra['fsk_dualtone']): the quadrature FM discriminator hits
        its click threshold when the in-filter CNR drops below ~10 dB — for
        m10 (dev 12 kHz, ~43 kHz occupied, a 21.6 kHz chanfilt is the
        narrowest legal) that is SNR ~8 dB, so at 4 dB the chip stream is
        click noise (3% BER == 14-33 bit errors/frame, far beyond any Chase
        repair). Mixing by +/-dev and comparing matched-lowpass envelopes
        is the classical noncoherent-orthogonal-FSK receiver and has NO
        threshold. Requires dev * n_proc / fs_proc to be an integer so the
        mixer is phase-continuous across blocks without extra carried
        state, and the one-chip boxcar to fit the overlap-save tail."""
        spec = self.spec
        cyc = spec.dev * (self.block_len // self.decim) / self.fs_proc
        return (spec.modulation in ("gfsk", "fsk")
                and bool(spec.extra.get("fsk_dualtone"))
                and abs(cyc - round(cyc)) < 1e-6
                and 2 <= round(self.sps) <= self.ntaps)

    @property
    def fs_proc(self) -> float:
        return self.fs / self.decim

    @property
    def sps(self) -> float:
        return self.fs_proc / self.spec.baud

    @property
    def chips_per_block(self) -> int:
        return int(round(self.block_len / self.decim / self.sps))

    @property
    def chip_cap(self) -> int:
        # block_len is an integer number of symbols and the NCO phase stays
        # in [0, sps), so every block emits EXACTLY chips_per_block chips —
        # which makes the ring-buffer shift a static slice (no gather)
        return self.chips_per_block

    @property
    def frame_chips(self) -> int:
        return self.spec.chips_per_frame

    @property
    def min_frame_chips(self) -> int:
        """Smallest on-air unit the sync can legitimately repeat at. For
        most families this is the frame itself; packetized protocols whose
        gather window is wider than the shortest packet (iMet-4) declare
        extra['min_frame_chips'] so slot capacity and the peak-suppression
        distance track real packet spacing."""
        return int(self.spec.extra.get("min_frame_chips", self.frame_chips))

    @property
    def k_slots(self) -> int:
        """Frame slots per channel per block. Frames are deduped on "end
        lies in this block's new chips", so at most ceil(cpb/min_frame_chips)
        can complete per block; +1 margin for sync jitter. Sizing the slots
        to the block keeps the host readback minimal."""
        if self.max_frames is not None:
            return self.max_frames
        return int(np.ceil(self.chips_per_block / self.min_frame_chips)) + 1

    @property
    def buf_len(self) -> int:
        # ring holds one full frame of history plus a block of new chips
        return self.frame_chips + self.chip_cap

    @property
    def wire_columns(self):
        """Byte columns of each frame that cross the device->host wire in
        the packed buffer (None = whole frame). Specs that define
        extra['wire_columns'] (the offsets their host parser reads) cut the
        readback ~2.6x; full frames for host FEC of RS-suspect rows are
        fetched separately via fetch_frames()."""
        return self.spec.extra.get("wire_columns")

    @property
    def wire_ncols(self) -> int:
        cols = self.wire_columns
        return self.spec.frame_bytes if cols is None else len(cols)

    @property
    def chase_m(self) -> int:
        """Soft-decision assist for checksum-only families (spec
        extra['chase_m']): the device ranks every decoded bit's reliability
        (min |soft chip| of its line-code pair) and ships the M weakest bit
        indices per frame; the host flips single/pair combinations of them
        when the checksum fails (a Chase-2 style repair). 0 = off."""
        return int(self.spec.extra.get("chase_m", 0))

    @property
    def chase_spans(self) -> tuple:
        """Bit ranges the weakest-bit ranking runs over — one top-M list
        per span. Multi-subtype windows declare extra['chase_spans'] so a
        SHORT subtype (M20 inside the M10-sized window) gets candidates
        inside ITS checksum span rather than in the noise tail beyond its
        frame; the host chases over the union of all lists."""
        if not self.chase_m:
            return ()
        spans = self.spec.extra.get("chase_spans")
        if spans is None:
            return ((0, self.spec.frame_bytes * 8),)
        return tuple(tuple(s) for s in spans)

    @property
    def chase_total(self) -> int:
        """Weak indices per frame on the wire: M per span."""
        return self.chase_m * len(self.chase_spans)

    @property
    def packed_row_bytes(self) -> int:
        """Per-channel width of the flat packed readback buffer."""
        k = self.k_slots
        return k * self.wire_ncols + 2 * k + 4 + 2 * k * self.chase_total


class PipelineState(NamedTuple):
    # IQ is carried as I/Q planes end to end (no complex64 on the device)
    chan_tail_i: jax.Array  # [C, ntaps-1] pre-demod channel-filter carry (I)
    chan_tail_q: jax.Array  # [C, ntaps-1] pre-demod channel-filter carry (Q)
    fm_prev: jax.Array      # [C, 2] float32: previous (I, Q) sample
    fir: FIRState
    timing: TimingState
    chipbuf: jax.Array      # [C, buf_len] soft chips (zeros before lock)
    buf_fill: jax.Array     # [C] int32, how many chips in buffer are real
    aux: tuple = ()         # modulation-specific carry (AFSK: 4 tone-filter
                            # tails [C, win-1] + phase counter [1])


class BlockOutput(NamedTuple):
    frames: jax.Array       # [C, K, frame_bytes] uint8 descrambled bytes
    frame_valid: jax.Array  # [C, K] bool
    frame_score: jax.Array  # [C, K] float32 sync correlation
    soft_rms: jax.Array     # [C] float32 chip-level signal quality
    rs_clean: jax.Array     # [C, K] bool: frame's RS syndromes all zero
    # frames + valid + rs_clean + soft_rms packed into ONE FLAT uint8 buffer
    # of C * (K*wire_ncols + 2K + 4) bytes: the steady-state host readback
    # is a single transfer. When the spec defines wire_columns, only those
    # frame byte columns are packed (the parser needs nothing else for
    # RS-clean frames); `frames` stays on device and suspect rows are
    # pulled with Pipeline.fetch_frames(). Unpack with
    # unpack_block_output().
    packed: jax.Array


def unpack_block_output(packed: np.ndarray, k_slots: int, frame_bytes: int,
                        chase_m: int = 0):
    """Split a host copy of BlockOutput.packed into (frames [C, K, fb] uint8,
    valid [C, K] bool, rs_clean [C, K] bool, soft_rms [C] float32[,
    weak_bits [C, K, M] int]).

    ``frame_bytes`` is the per-frame wire width: config.wire_ncols (== the
    full spec.frame_bytes unless the spec defines compact wire_columns);
    ``chase_m`` adds the per-frame weakest-bit indices (config.chase_m)."""
    row = k_slots * frame_bytes + 2 * k_slots + 4 + 2 * k_slots * chase_m
    c = packed.size // row
    packed = packed.reshape(c, row)
    fbk = k_slots * frame_bytes
    frames = packed[:, :fbk].reshape(c, k_slots, frame_bytes)
    valid = packed[:, fbk:fbk + k_slots].astype(bool)
    rs_clean = packed[:, fbk + k_slots: fbk + 2 * k_slots].astype(bool)
    off = fbk + 2 * k_slots
    soft_rms = np.ascontiguousarray(packed[:, off:off + 4]
                                    ).view(np.float32)[:, 0]
    if not chase_m:
        return frames, valid, rs_clean, soft_rms
    wb = np.ascontiguousarray(packed[:, off + 4:]).view(np.uint16)
    weak = wb.reshape(c, k_slots, chase_m).astype(np.int64)
    return frames, valid, rs_clean, soft_rms, weak


class Pipeline:
    """Compiled per-block decoder front end for one sonde type."""

    def __init__(self, config: PipelineConfig, mesh=None):
        self.config = config
        spec = config.spec
        c = config

        # kept as NumPy: baked into the jitted program as constants without a
        # device round-trip
        nyq_cut = 0.55 * spec.baud
        # matched filter runs at the (possibly decimated) processing rate
        self._taps = design_lowpass(nyq_cut, c.fs_proc, c.ntaps)
        # pre-demod channel filter at the sonde's bandwidth (the reference's
        # VFO filters to spec bandwidth before the FM demod, main.cpp:55-57;
        # without it the discriminator sees the full fs noise bandwidth and
        # hits its threshold ~7 dB earlier). For narrowband types the filter
        # also decimates (strided conv, config.decim).
        self._chan_taps = design_lowpass(
            min(spec.bandwidth / 2.0, 0.45 * c.fs_proc), c.fs, c.ntaps)
        self._template = spec.sync_chip_template()
        alts = []
        alt = spec.extra.get("alt_syncword")
        if alt:
            alts.append(spec.sync_chip_template(alt))
        for b in spec.extra.get("alt_sync_bits", ()):
            # non-byte-aligned alternates (e.g. iMet-4's per-packet-type
            # async-serial headers); correlated alongside the main template
            alts.append(spec.sync_chip_template(bits=np.asarray(b)))
        self._alt_templates = alts
        self._fs = c.fs
        self._dev = spec.dev
        self._afsk = spec.modulation == "afsk"
        n_proc = c.block_len // c.decim
        self._dualtone = c.dualtone
        if spec.extra.get("fsk_dualtone") and not self._dualtone \
                and spec.modulation in ("gfsk", "fsk"):
            # the spec ASKS for the noncoherent dual-tone front end but the
            # config can't host it — falling back to the click-prone FM
            # discriminator silently costs the several-dB FER gain the flag
            # exists for, so name the failed condition once
            import warnings
            phase_ok = abs(spec.dev * n_proc / c.fs_proc
                           - round(spec.dev * n_proc / c.fs_proc)) < 1e-6
            why = ("dev*block/fs_proc=%g not integer (mixer would lose "
                   "phase continuity)" % (spec.dev * n_proc / c.fs_proc)
                   if not phase_ok else
                   "sps=%g outside [2, ntaps=%d]" % (c.sps, c.ntaps))
            warnings.warn(
                f"{c.sonde}: fsk_dualtone requested but unavailable for "
                f"this config ({why}); falling back to the FM "
                f"discriminator (worse low-SNR FER)", stacklevel=3)
        # wideband FSK families (m10: 50 kHz occupied on a 48 kHz channel)
        # get a chanfilt cutoff pinned AT the 0.45*fs_proc anti-alias
        # guard — a near-transparent filter costing 4 T-tap convs per
        # block. The dual-tone boxcar after mixing is the real matched
        # filter and kills everything the guard would have (mix by +/-dev
        # then ~baud-wide lowpass), so the guard is SKIPPED for dual-tone
        # families whose bandwidth reaches the guard cutoff. The jnp path
        # and the kernel share the flag (parity tests hold them equal).
        self._skip_chanfilt = (self._dualtone
                               and spec.bandwidth / 2.0 >= 0.45 * c.fs_proc)
        if self._dualtone:
            # the TRUE matched filter for (near-)rectangular chips is a
            # one-chip integrator (boxcar of sps taps), not the 0.55*baud
            # lowpass: a longer filter correlates noise across chips and
            # smears ISI. Padded to ntaps so the overlap-save tail width
            # matches the state layout.
            self._box = np.zeros(c.ntaps, np.float32)
            nb = max(2, int(round(c.sps)))
            self._box[-nb:] = 1.0 / nb
        if self._afsk:
            self._afsk_win = max(int(c.fs / spec.baud), 2)
        # the fused dual-tone kernel: compiled only for a GPU; the Pallas
        # interpreter runs only when the config asks for it by name
        use = c.use_pallas
        if use is None:
            use = (self._dualtone and c.decim == 1
                   and jax.default_backend() == "gpu")
        self._kernel = bool(use)
        self._interpret = use == "interpret"
        if use is True and jax.default_backend() != "gpu":
            raise ValueError(
                "use_pallas=True compiles the dual-tone kernel for a GPU, "
                f"but the default backend is {jax.default_backend()!r}; "
                "use_pallas='interpret' runs it in the Pallas interpreter")
        # a mesh-sharded step runs the kernel per channel shard (GSPMD
        # cannot partition a pallas_call)
        self._mesh = mesh
        donate = () if c.profile_stop else (0,)
        self._step = jax.jit(self._step_impl, donate_argnums=donate)

    # -- state -------------------------------------------------------------

    def init_state(self) -> PipelineState:
        # NumPy leaves: the first step() uploads them
        c = self.config
        aux = ()
        if self._afsk:
            w = self._afsk_win - 1
            aux = tuple(np.zeros((c.channels, w), np.float32)
                        for _ in range(4)) + (np.zeros((1,), np.int32),)
        if c.fine_offsets is not None or c.afc:
            aux = aux + (np.zeros((c.channels,), np.float32),)   # DDC phase
        if c.afc:
            f0 = (np.asarray(c.fine_offsets, np.float32)
                  if c.fine_offsets is not None
                  else np.zeros((c.channels,), np.float32))
            aux = aux + (f0.copy(),)   # DDC freq (Hz), AFC-tracked
        # the dual-tone kernel carries the raw input history its combined
        # filter reads; the jnp path carries ntaps-1 raw input samples
        if self._kernel:
            from sondetpu.pallas.dualtone import history
            tail_w = history(self._chan_taps, self._box, self._skip_chanfilt)
        else:
            tail_w = c.ntaps - 1
        # sample-rate carries live in the compute dtype (bf16 halves their
        # HBM traffic; all reductions stay f32 — see compute_dtype)
        import ml_dtypes
        sdt = ml_dtypes.bfloat16 if c.compute_dtype == "bf16" else np.float32
        return PipelineState(
            chan_tail_i=np.zeros((c.channels, tail_w), sdt),
            chan_tail_q=np.zeros((c.channels, tail_w), sdt),
            fm_prev=np.zeros((c.channels, 2), sdt),
            # dualtone carries the 4 mixed planes' (+/- tone I/Q) filter
            # history; the discriminator path carries the audio tail
            fir=FIRState(tail=np.zeros(
                (c.channels * (4 if self._dualtone else 1), c.ntaps - 1),
                sdt)),
            timing=TimingState(pos=np.zeros((c.channels,), np.float32),
                               locked=np.zeros((c.channels,), np.float32)),
            chipbuf=np.zeros((c.channels, c.buf_len), sdt),
            buf_fill=np.zeros((c.channels,), np.int32),
            aux=aux,
        )

    # -- the jitted step ---------------------------------------------------

    def step(self, state: PipelineState, iq):
        """iq: [channels, block_len] complex64 (host) or an (i, q) float32
        plane pair -> (state, BlockOutput)."""
        if isinstance(iq, tuple):
            i, q = iq
        else:
            if self.config.input_dtype != "f32":
                raise TypeError("input_dtype %r needs raw integer (i, q) "
                                "planes, not complex" % self.config.input_dtype)
            from sondetpu.io.iq import c64_to_planes

            i, q = c64_to_planes(np.asarray(iq))
        return self._step(state, i, q)

    def fetch_frames(self, frames_dev, ch_idx, slot_idx) -> np.ndarray:
        """Pull specific (channel, slot) full frames from a device-resident
        BlockOutput.frames: the suspect path of the compact wire-column
        readback (frames the host must RS-correct). Indices are padded to a
        power-of-two bucket so the gather program compiles O(log n) times."""
        n = len(ch_idx)
        if n == 0:
            return np.zeros((0, self.config.spec.frame_bytes), np.uint8)
        flat = (np.asarray(ch_idx, np.int32) * self.config.k_slots
                + np.asarray(slot_idx, np.int32))
        bucket = max(8, 1 << (n - 1).bit_length())
        idx = np.zeros(bucket, np.int32)
        idx[:n] = flat
        if not hasattr(self, "_fetch_fn"):
            fb = self.config.spec.frame_bytes
            self._fetch_fn = jax.jit(
                lambda f, i: jnp.take(f.reshape(-1, fb), i, axis=0))
        return np.asarray(self._fetch_fn(frames_dev, idx))[:n]

    def _afsk_frontend(self, state: PipelineState, audio: jax.Array):
        """Dual-tone AFSK discriminator with carried tone-filter tails and
        LO phase (SURVEY.md S5: 'dual-tone Goertzel/quadrature discriminator
        kernel'). Returns (soft in [-1,1], fir_state passthrough, aux)."""
        spec = self.config.spec
        fs = self._fs
        win = self._afsk_win
        box = np.ones(win, np.float32) / win
        n = audio.shape[-1]
        t_mark, t_space = spec.afsk_mark, spec.afsk_space
        # LO phase repeats every L samples for both tones (exact int cycles)
        from fractions import Fraction
        L = np.lcm(Fraction(t_mark / fs).limit_denominator(1 << 20).denominator,
                   Fraction(t_space / fs).limit_denominator(1 << 20).denominator)
        count = state.aux[4][0]
        idx = count.astype(jnp.float32) + jnp.arange(n, dtype=jnp.float32)

        energies = []
        new_tails = []
        for j, f in enumerate((t_mark, t_space)):
            w = 2.0 * jnp.pi * f / fs
            ci = audio * jnp.cos(w * idx)
            cq = audio * jnp.sin(w * idx)
            ti, tq = state.aux[2 * j], state.aux[2 * j + 1]
            fi = _apply_windows(jnp.concatenate([ti, ci], axis=-1), box)
            fq = _apply_windows(jnp.concatenate([tq, cq], axis=-1), box)
            energies.append(fi * fi + fq * fq)
            new_tails += [ci[:, -(win - 1):], cq[:, -(win - 1):]]
        em, es = energies
        soft = (em - es) / (em + es + 1e-9)
        aux = tuple(new_tails) + (((count + n) % int(L))[None].astype(jnp.int32),)
        return soft, state.fir, aux

    def _sample_symbols(self, filt: jax.Array, start: jax.Array, sps: float,
                        cpb: int) -> jax.Array:
        """Linear-interpolate symbol centers at start + k*sps, k < cpb.

        Integer sps (most families): the fractional part of the position is
        constant per channel, so sampling is a per-channel weighted sum of
        sps+1 STRIDED slices — no gather.

        Rational sps = p/q with small q (dfm: 19.2 = 96/5): the fractional
        position pattern repeats every q chips / p samples, so the block
        splits into n/p segments of p samples holding exactly q chips each
        and sampling becomes one batched [n/p, p]x[p, q] contraction per
        channel against a dense interpolation-weight matrix — a matmul
        instead of a take_along_axis gather of every chip; the contraction
        is ~250 MMACs at 256 ch x 4 s.

        Irrational/large-q sps falls back to the gather.
        """
        n = filt.shape[-1]
        if float(sps).is_integer():
            isps = int(sps)
            s0 = jnp.floor(start).astype(jnp.int32)        # [C] in [0, sps)
            frac = (start - s0.astype(jnp.float32))[:, None]
            fp = jnp.pad(filt, ((0, 0), (0, isps + 1)), mode="edge")
            # accumulate f32 even when filt is stored bf16 (weights are f32,
            # so the products promote; only the fp READS are narrow)
            soft = jnp.zeros((filt.shape[0], cpb), jnp.float32)
            for j in range(isps + 1):
                w = jnp.where(s0 == j, 1.0 - frac[:, 0],
                              jnp.where(s0 + 1 == j, frac[:, 0], 0.0))[:, None]
                soft = soft + w * fp[:, j: j + isps * cpb: isps][:, :cpb]
            return soft
        from fractions import Fraction
        fr = Fraction(sps).limit_denominator(16)
        p, q = fr.numerator, fr.denominator
        if (abs(float(fr) - float(sps)) < 1e-9 and q > 1
                and cpb % q == 0 and n == (cpb // q) * p):
            G = n // p                                  # segments per block
            C = filt.shape[0]
            seg = filt.reshape(C, G, p)
            # chip position inside a segment: start + j*sps, j < q; the
            # interpolation may touch the first sample of the NEXT segment
            # (pos + 1 can reach p), carried as a separate rank-1 term so
            # no [C, G, p+1] copy is materialized
            j = jnp.arange(q, dtype=jnp.float32)
            pos = start[:, None] + j[None, :] * jnp.float32(sps)   # [C, q]
            i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, p - 1)
            frac = jnp.clip(pos - i0.astype(jnp.float32), 0.0, 1.0)
            oh0 = jax.nn.one_hot(i0, p + 1, dtype=jnp.float32)
            oh1 = jax.nn.one_hot(i0 + 1, p + 1, dtype=jnp.float32)
            w = oh0 * (1.0 - frac)[..., None] + oh1 * frac[..., None]
            # full-f32 contraction: default matmul precision truncates the
            # interpolation weights to bf16 (~0.4% weight error -> visible
            # soft-bit noise); the op is tiny so HIGHEST costs nothing
            soft = jnp.einsum("cgn,cjn->cgj", seg.astype(jnp.float32),
                              w[:, :, :p], precision=jax.lax.Precision.HIGHEST)
            # next-segment first sample (edge-pad the block's last one)
            fp = jnp.pad(filt, ((0, 0), (0, 1)), mode="edge")
            nxt = fp[:, p::p][:, :G].astype(jnp.float32)           # [C, G]
            soft = soft + nxt[:, :, None] * w[:, None, :, p]
            # chips in temporal order: segment-major, j-minor
            return soft.reshape(C, cpb)
        from sondetpu.sync.timing import _linear_interp
        k = jnp.arange(cpb, dtype=jnp.float32)
        pos = start[:, None] + k[None, :] * sps
        return _linear_interp(filt, pos)

    def _dualtone_xla(self, fir_tail, iq_i, iq_q):
        """Dual-tone noncoherent FSK front end in jnp: planes [C, n] (the
        compute dtype) + the mixed planes' carry [4C, ntaps-1] ->
        (envelope metric [C, n] f32, FIRState, AFC rotation sums
        (re [C], im [C]) or None when AFC is off).

        Mix the channel by -/+dev (the two FSK tones land at DC of the
        p/m plane pairs), matched-lowpass all four planes in ONE batched
        conv (overlap-save carry in fir.tail), and take the normalized
        envelope difference as the soft chip metric in [-1, 1] — same
        scale as the discriminator's audio/dev, so dc-block, slicing,
        weak-bit ranking and soft_rms are unchanged. No FM click
        threshold (see PipelineConfig.dualtone). The mixer needs no
        carried phase: dev*n/fs_proc is integer, so e^{-j*ang} repeats
        exactly every block."""
        c = self.config
        n = iq_i.shape[-1]
        cc = iq_i.shape[0]
        # HOST-side f64 mixer table (block-constant): f32 cos/sin at
        # arguments up to 2*pi*dev*n/fs ~ 1e5 rad lose their precision to
        # range reduction; wrapping the phase to [0, 1) cycles in f64
        # before the trig keeps it exact.
        frac = np.mod(np.arange(n, dtype=np.float64)
                      * (float(self._dev) / float(c.fs_proc)), 1.0)
        cv = jnp.asarray(np.cos(2.0 * np.pi * frac), jnp.float32)[None, :]
        sv = jnp.asarray(np.sin(2.0 * np.pi * frac), jnp.float32)[None, :]
        ii32 = iq_i.astype(jnp.float32)
        qq32 = iq_q.astype(jnp.float32)
        planes = jnp.concatenate([
            ii32 * cv + qq32 * sv,      # +tone I  (x * e^{-j ang})
            qq32 * cv - ii32 * sv,      # +tone Q
            ii32 * cv - qq32 * sv,      # -tone I  (x * e^{+j ang})
            qq32 * cv + ii32 * sv,      # -tone Q
        ], axis=0)
        xp4 = jnp.concatenate([fir_tail, planes.astype(iq_i.dtype)], axis=-1)
        lp = _apply_windows(xp4, jnp.asarray(self._box))
        fir_state = FIRState(tail=xp4[:, -(c.ntaps - 1):])
        pp = lp[:cc] ** 2 + lp[cc:2 * cc] ** 2
        pm = lp[2 * cc:3 * cc] ** 2 + lp[3 * cc:] ** 2
        audio = (pp - pm) / (pp + pm + np.float32(1e-12))
        if not c.afc:
            return audio, fir_state, None
        # AFC discriminant: a residual offset df rotates BOTH mixed-down
        # tone envelopes at exactly df (the active tone's envelope
        # dominates, the idle plane is noise the matched lowpass has
        # already crushed), so the power-weighted mean phase advance of
        # the lp planes measures df directly — in the same audio/dev units
        # the loop expects. (A strided raw discriminator is NOT usable:
        # GFSK transition samples don't alias away and bias the mean.)
        lpf = lp.astype(jnp.float32)
        pi_, pq_ = lpf[:cc], lpf[cc:2 * cc]
        mi_, mq_ = lpf[2 * cc:3 * cc], lpf[3 * cc:]
        rot_re = (pi_[:, 1:] * pi_[:, :-1] + pq_[:, 1:] * pq_[:, :-1]
                  + mi_[:, 1:] * mi_[:, :-1] + mq_[:, 1:] * mq_[:, :-1])
        rot_im = (pq_[:, 1:] * pi_[:, :-1] - pi_[:, 1:] * pq_[:, :-1]
                  + mq_[:, 1:] * mi_[:, :-1] - mi_[:, 1:] * mq_[:, :-1])
        return audio, fir_state, (jnp.sum(rot_re, axis=-1),
                                  jnp.sum(rot_im, axis=-1))

    def _fused_dualtone(self, iq_i, iq_q, tail_i, tail_q):
        """The dual-tone kernel over this step's planes; under a mesh it
        runs once per channel shard (GSPMD cannot partition a
        pallas_call)."""
        from sondetpu.pallas.dualtone import fused_dualtone_frontend
        c = self.config
        fn = partial(fused_dualtone_frontend,
                     chan_taps=tuple(map(float, self._chan_taps)),
                     box=tuple(map(float, self._box)),
                     dev_over_fs=float(self._dev) / float(c.fs_proc),
                     skip_chanfilt=self._skip_chanfilt,
                     want_afc=bool(c.afc),
                     interpret=self._interpret)
        if self._mesh is None:
            return fn(iq_i, iq_q, tail_i, tail_q)
        from jax.sharding import PartitionSpec as P
        from sondetpu.parallel.sharding import mesh_channel_axes
        ax = mesh_channel_axes(self._mesh)
        rows, vec = P(ax, None), P(ax)
        return jax.shard_map(fn, mesh=self._mesh, in_specs=(rows,) * 4,
                             out_specs=(rows, rows, rows, vec, vec, vec),
                             check_vma=False)(iq_i, iq_q, tail_i, tail_q)

    def _afc_update(self, freq_hz, dc):
        """First-order AFC loop update -> 1-tuple for the aux tail.

        ``dc`` is the residual-offset discriminant in audio/dev units
        (discriminator DC, or the dual-tone envelope-rotation angle). The
        clamp bounds the drift EXCURSION relative to each channel's SEED
        frequency, not the absolute DDC frequency: seeds come from
        bin_and_offset and are legitimately far beyond bandwidth/2."""
        c = self.config
        maxhz = np.float32(c.afc_max_hz if c.afc_max_hz is not None
                           else c.spec.bandwidth / 2.0)
        f_seed = jnp.asarray(
            np.asarray(c.fine_offsets, np.float32)
            if c.fine_offsets is not None
            else np.zeros((c.channels,), np.float32))
        return (f_seed + jnp.clip(
            freq_hz + np.float32(c.afc_beta) * dc * np.float32(self._dev)
            - f_seed, -maxhz, maxhz),)

    def _step_impl(self, state: PipelineState, iq_i: jax.Array, iq_q: jax.Array):
        c = self.config
        cdt = jnp.bfloat16 if c.compute_dtype == "bf16" else jnp.float32
        if c.input_dtype != "f32":
            # device-side dequant of raw SDR integer planes; XLA fuses the
            # convert+scale into the first consumer, so the only cost saved
            # is the host->device wire (2x/4x narrower)
            qs = np.float32(1.0 / 32768.0 if c.input_dtype == "i16"
                            else 1.0 / 128.0)
            iq_i = iq_i.astype(jnp.float32) * qs
            iq_q = iq_q.astype(jnp.float32) * qs
        sps = c.sps
        # phase-diff scale at the post-decimation processing rate
        scale = c.fs_proc / (2.0 * jnp.pi * self._dev)
        n = iq_i.shape[-1]

        afc_freq = ()
        if c.fine_offsets is not None or c.afc:
            # per-channel DDC: rotate by -2*pi*f_off*t (phase carried in aux
            # as a [C] float in cycles, wrapped each block). With afc the
            # frequency itself is state (aux slot -1), seeded by
            # fine_offsets and updated below from the discriminator DC.
            if c.afc:
                freq_hz = state.aux[-1]                # [C] dynamic, Hz
                phase0 = state.aux[-2][:, None]        # [C, 1] cycles
            else:
                freq_hz = jnp.asarray(np.asarray(c.fine_offsets, np.float32))
                phase0 = state.aux[-1][:, None]
            f_norm = freq_hz[:, None] / np.float32(self._fs)
            cyc = phase0 + f_norm * jnp.arange(n, dtype=jnp.float32)[None, :]
            ang = -2.0 * jnp.pi * cyc
            cosv, sinv = jnp.cos(ang), jnp.sin(ang)
            iq_i, iq_q = (iq_i * cosv - iq_q * sinv, iq_i * sinv + iq_q * cosv)
            ddc_phase = (jnp.mod(phase0[:, 0] + np.float32(n) * f_norm[:, 0], 1.0),)
        else:
            freq_hz = None
            ddc_phase = ()
        # sample-rate arrays are STORED in the compute dtype from here on
        # (the dequant/DDC math above runs f32); no-op when cdt is f32
        iq_i = iq_i.astype(cdt)
        iq_q = iq_q.astype(cdt)

        if self._kernel:
            # fused dual-tone front end (sondetpu/pallas/dualtone.py): the
            # planes are read once and the envelope metric written once;
            # mean-DC from the kernel's per-chunk sums, midpoint-DC in XLA
            # on the metric (as the jnp path's quantile over audio), AFC
            # from the kernel's envelope-rotation sums
            audio, new_ctail_i, new_ctail_q, dc_mean, rot_re, rot_im = \
                self._fused_dualtone(iq_i, iq_q, state.chan_tail_i,
                                     state.chan_tail_q)
            if c.spec.extra.get("dc_mode") == "midpoint":
                lo = jnp.quantile(audio, 0.10, axis=-1)
                hi = jnp.quantile(audio, 0.90, axis=-1)
                dc = 0.5 * (lo + hi)
            else:
                dc = dc_mean
            if c.dc_block:
                audio = audio - dc[:, None]
            if c.afc:
                ang = jnp.arctan2(rot_im, rot_re)
                afc_freq = self._afc_update(
                    freq_hz,
                    ang * np.float32(c.fs_proc / (2.0 * np.pi * self._dev)))
            filt = audio           # the boxcar IS the matched filter
            fm_state = state.fm_prev       # unused on this path
            fir_state = state.fir
            aux_state = ()
            if c.profile_stop == "chanfilt":   # fused: chanfilt==demod here
                return jnp.sum(filt)
        else:
            # pre-demod channel filter (reference VFO bandwidth,
            # main.cpp:55-57); for narrowband types the strided conv also
            # decimates (c.decim), halving every stage after it. Wideband
            # dual-tone families skip the near-transparent guard filter
            # entirely (_skip_chanfilt): the post-mix boxcar is the real
            # matched filter.
            new_ctail_i = iq_i[:, -(c.ntaps - 1):]
            new_ctail_q = iq_q[:, -(c.ntaps - 1):]
            if not self._skip_chanfilt:
                xpi = jnp.concatenate([state.chan_tail_i, iq_i], axis=-1)
                xpq = jnp.concatenate([state.chan_tail_q, iq_q], axis=-1)
                # conv reads cdt, accumulates f32; store cdt for the
                # demod reads
                iq_i = _apply_windows(xpi, self._chan_taps,
                                      stride=c.decim).astype(cdt)
                iq_q = _apply_windows(xpq, self._chan_taps,
                                      stride=c.decim).astype(cdt)
            n = iq_i.shape[-1]             # processing length from here on
            if c.profile_stop == "chanfilt":
                return jnp.sum(iq_i) + jnp.sum(iq_q)

            fm_state = jnp.stack([iq_i[:, -1], iq_q[:, -1]], axis=-1)
            fir_state = None
            afc_dc = None     # dualtone AFC discriminant (audio dc elsewhere)
            if self._dualtone:
                # optimal noncoherent FSK (the jnp twin of the fused
                # kernel; see _dualtone_xla)
                audio, fir_state, rot = self._dualtone_xla(
                    state.fir.tail, iq_i, iq_q)
                if rot is not None:
                    afc_dc = jnp.arctan2(rot[1], rot[0]) * np.float32(
                        c.fs_proc / (2.0 * np.pi * self._dev))
            else:
                # L2: FM quadrature discriminator on I/Q planes (ref
                # main.cpp:57): d = x[n]*conj(x[n-1]);
                # audio = atan2(im(d), re(d)) * fs/(2*pi*dev)
                # (math in f32 — the casts fuse into the reads, so HBM
                # traffic stays at the storage dtype)
                pi_ = jnp.concatenate([state.fm_prev[:, 0:1], iq_i[:, :-1]],
                                      axis=-1).astype(jnp.float32)
                pq_ = jnp.concatenate([state.fm_prev[:, 1:2], iq_q[:, :-1]],
                                      axis=-1).astype(jnp.float32)
                ii32 = iq_i.astype(jnp.float32)
                qq32 = iq_q.astype(jnp.float32)
                dre = ii32 * pi_ + qq32 * pq_
                dim = qq32 * pi_ - ii32 * pq_
                audio = jnp.arctan2(dim, dre) * scale
            if c.spec.extra.get("dc_mode") == "midpoint":
                # robust two-level slicer reference: unwhitened-NRZ frames
                # (ims100/mrzn1) carry a strong DATA dc (zero-byte runs), so
                # the block mean lands off-center and flips isolated bits;
                # the midpoint of the low/high FSK levels (10th/90th
                # percentile) tracks only the carrier offset
                lo = jnp.quantile(audio, 0.10, axis=-1)
                hi = jnp.quantile(audio, 0.90, axis=-1)
                dc = 0.5 * (lo + hi)
            else:
                dc = jnp.mean(audio, axis=-1)
            if c.dc_block:
                audio = audio - dc[:, None]
            if c.afc:
                # discriminator DC of 1.0 == spec.dev Hz of residual
                # carrier offset (scale above); first-order loop
                # (_afc_update)
                afc_freq = self._afc_update(
                    freq_hz, afc_dc if afc_dc is not None else dc)

            if self._afsk:
                # AFSK front end: dual-tone quadrature discriminator (S5/S6)
                filt, fir_state, aux_state = self._afsk_frontend(state, audio)
            elif self._dualtone:
                # the envelope metric is already matched-filtered (the
                # lowpass above IS the chip filter); an extra FIR here
                # would smear adjacent chips
                filt = audio
                aux_state = ()
            else:
                # matched/channel filter with overlap-save carry (SURVEY.md S0)
                xp = jnp.concatenate([state.fir.tail, audio.astype(cdt)],
                                     axis=-1)
                ntaps = self._taps.shape[0]
                filt = _apply_windows(xp, self._taps)
                fir_state = FIRState(tail=xp[:, -(ntaps - 1):])
                aux_state = ()

        if c.profile_stop == "demod":
            return jnp.sum(filt)
        filt = filt.astype(cdt)   # storage dtype for the strided sample reads
        # symbol timing: feed-forward estimate + slew-limited NCO carry
        tau = oerder_meyr_tau(filt, sps)
        err = jnp.mod(tau - state.timing.pos + sps / 2.0, sps) - sps / 2.0
        corrected = state.timing.pos + jnp.clip(err, -0.5, 0.5)
        start = jnp.where(state.timing.locked > 0, corrected, tau)
        # clamp, don't wrap: crossing the 0/sps boundary via mod skips or
        # repeats one symbol (see sync/timing.py symbol_sample)
        start = jnp.clip(start, 0.0, sps - 1e-3)
        cpb = c.chips_per_block
        # exactly cpb chips fit (start in [0, sps), block % sps == 0)
        next_pos = start + cpb * sps - n
        timing_state = TimingState(pos=next_pos, locked=jnp.ones_like(state.timing.locked))
        if c.profile_stop == "timing":
            return jnp.sum(start) + jnp.sum(next_pos)
        soft = self._sample_symbols(filt, start, sps, cpb)
        if c.profile_stop == "sample":
            return jnp.sum(soft)

        # chip ring buffer: constant cpb new chips -> static slice, no gather
        ext = jnp.concatenate([state.chipbuf, soft.astype(cdt)],
                              axis=-1)   # [C, buf+cpb]
        chipbuf = ext[:, cpb:]
        nvalid = cpb
        buf_fill = jnp.minimum(state.buf_fill + cpb, c.buf_len)

        # frame sync: correlate + peak pick + gather (SURVEY.md S0)
        corr = correlate_syncword(chipbuf, self._template)
        if c.spec.extra.get("abs_corr"):
            # biphase-M is polarity-ambiguous: match either polarity
            corr = jnp.abs(corr)
        for alt_t in self._alt_templates:
            # subtype/packet-type with a different sync on the same channel
            # (M20 on the M10/M20 entry, iMet-4 packet headers): accept
            # whichever template matches best
            corr2 = correlate_syncword(chipbuf, alt_t)
            if c.spec.extra.get("abs_corr"):
                corr2 = jnp.abs(corr2)
            m = min(corr.shape[-1], corr2.shape[-1])
            corr = jnp.maximum(corr[:, :m], corr2[:, :m])
        if c.profile_stop == "corr":
            return jnp.sum(corr)
        min_dist = max(self.config.min_frame_chips // 4,
                       self._template.shape[0])
        starts, ok = find_frame_starts(corr, self.config.sync_threshold,
                                       c.k_slots, min_dist)
        if c.profile_stop == "peaks":
            return jnp.sum(starts) + jnp.sum(ok)
        # dedup across blocks: only frames whose END lies in the new chips
        is_new = (starts + c.frame_chips) > (c.buf_len - nvalid)
        # and whose start lies within real (filled) history
        in_hist = starts >= (c.buf_len - buf_fill)[:, None]
        fit = (starts + c.frame_chips) <= c.buf_len
        frame_valid = ok & fit & is_new & in_hist
        # chip -> byte assembly on device (8x smaller host readback)
        spec = c.spec
        w = np.array([1, 2, 4, 8, 16, 32, 64, 128] if spec.lsb_first
                     else [128, 64, 32, 16, 8, 4, 2, 1], dtype=np.float32)
        safe = jnp.clip(starts, 0, max(c.buf_len - c.frame_chips, 0))
        if spec.line_code == "nrz":
            # instead of gathering [C, K, frame_chips] chips and packing
            # after, pack the WHOLE chip buffer into bytes at every chip
            # offset with one 8-tap conv, then gather only
            # [C, K, frame_bytes] BYTES, as ONE contiguous uint8 slice per
            # slot via lax.gather slice_sizes (not an element gather):
            # byte_at is regrouped [C, 8, buf//8] so the stride-8 byte
            # sequence of a frame becomes a contiguous run.
            from sondetpu.dsp.fir import _conv1d
            # 0/1 chips and the 8 power-of-two weights are exact in either
            # dtype; the conv accumulates f32 regardless.
            hardf = jnp.where(chipbuf > 0, jnp.asarray(1.0, cdt),
                              jnp.asarray(0.0, cdt))
            byte_at = _conv1d(hardf, jnp.asarray(w))       # [C, buf_len - 7]
            cc, kk, fb = byte_at.shape[0], safe.shape[1], spec.frame_bytes
            pad = (-byte_at.shape[-1]) % 8
            sub = jnp.pad(byte_at, ((0, 0), (0, pad)))
            sub = sub.reshape(cc, -1, 8).transpose(0, 2, 1).astype(jnp.uint8)
            bq = sub.shape[-1]                             # [C, 8, bq]
            sub = sub.reshape(cc * 8, bq)  # 2-D operand gathers lower ~30%
            q = jnp.minimum(safe // 8, bq - fb)            # faster than 3-D
            r = safe - 8 * (safe // 8)
            rows = jnp.arange(cc)[:, None] * 8 + r
            idx = jnp.stack([rows, q], axis=-1).reshape(cc * kk, 2)
            frames = jax.lax.gather(
                sub, idx,
                jax.lax.GatherDimensionNumbers(
                    offset_dims=(1,), collapsed_slice_dims=(0,),
                    start_index_map=(0, 1)),
                slice_sizes=(1, fb)).reshape(cc, kk, fb)
        weak = None
        if spec.line_code != "nrz":
            if c.chase_m:
                # soft-decision assist: gather SOFT chips once, derive the
                # hard decisions from the gathered values, and rank every
                # decoded bit's reliability as min(|a|, |b|) of its chip
                # pair (the LLR magnitude of the XOR/transition decision).
                # The M weakest bit indices per frame ride the packed
                # buffer; the host flips them when the checksum fails
                # (Chase-2 repair for the checksum-only 9600 Bd families).
                soft_fr, _ = gather_frames(chipbuf.astype(jnp.float32),
                                           starts, ok, c.frame_chips)
                chips = jnp.where(soft_fr > 0, jnp.uint8(1), jnp.uint8(0))
                rel = jnp.minimum(jnp.abs(soft_fr[..., 0::2]),
                                  jnp.abs(soft_fr[..., 1::2]))
                # one top-M list per declared span (chase_spans): a short
                # subtype's candidates stay inside its own checksum range.
                # approx_max_k: the weak list is a heuristic candidate set,
                # re-verified by the chase's checksum pass (chase-repair FER
                # gates hold, test_sonde_families). On a GPU and the CPU XLA
                # lowers it to an exact top-k (a sort).
                lists = []
                for a, b in c.chase_spans:
                    _, idx = jax.lax.approx_max_k(-rel[..., a:b], c.chase_m)
                    lists.append(idx.astype(jnp.int32) + np.int32(a))
                weak = jnp.concatenate(lists, axis=-1)      # [C, K, S*M]
            else:
                # hard path: gather hard chips (uint8) only
                hard_chips = jnp.where(chipbuf > 0, jnp.uint8(1),
                                       jnp.uint8(0))
                chips, _ = gather_frames(hard_chips, starts, ok,
                                         c.frame_chips)
            if spec.line_code == "manchester":
                chips = manchester_decode(chips)
            elif spec.line_code == "biphase_m":
                chips = biphase_m_decode(chips)
            bits8 = chips.reshape(chips.shape[0], chips.shape[1],
                                  spec.frame_bytes, 8)
            frames = jnp.sum(bits8.astype(jnp.int32) * w.astype(np.int32),
                             axis=-1).astype(jnp.uint8)
        if c.profile_stop == "gather":
            return jnp.sum(frames.astype(jnp.int32))
        mask = spec.extra.get("whitening")
        if mask is not None:
            full = np.resize(np.asarray(mask, np.uint8), spec.frame_bytes)
            frames = jnp.bitwise_xor(frames, full)
        score = jnp.take_along_axis(
            jnp.pad(corr, ((0, 0), (0, c.frame_chips))), starts, axis=-1)

        soft_rms = jnp.sqrt(jnp.mean(soft * soft, axis=-1))
        # decode-stage device kernel: RS syndrome check as a GF(2) matmul —
        # frames flagged clean skip host FEC entirely (fec/syndrome.py)
        rs_layout = spec.extra.get("rs")
        if rs_layout is not None:
            from sondetpu.fec.syndrome import rs_clean_flags
            rs_clean = rs_clean_flags(frames, rs_layout)
            rs_clean = rs_clean & frame_valid
        else:
            rs_clean = jnp.zeros_like(frame_valid)
        if c.profile_stop == "syndrome":
            return jnp.sum(rs_clean) + jnp.sum(frame_valid)
        # spec-declared wire columns: only the byte columns the host parser
        # reads cross the wire; full frames stay device-resident for the
        # (rare) RS-suspect fetch path
        cols = c.wire_columns
        wire = frames if cols is None else jnp.take(
            frames, jnp.asarray(np.asarray(cols, np.int32)), axis=-1)
        parts = [
            wire.reshape(wire.shape[0], -1),
            frame_valid.astype(jnp.uint8),
            rs_clean.astype(jnp.uint8),
            jax.lax.bitcast_convert_type(soft_rms, jnp.uint8),
        ]
        if c.chase_m:
            # weakest-bit indices as u16 LE pairs (packed_row_bytes)
            wb = jax.lax.bitcast_convert_type(weak.astype(jnp.uint16),
                                              jnp.uint8)
            parts.append(wb.reshape(wb.shape[0], -1))
        packed = jnp.concatenate(parts, axis=-1).reshape(-1)
        out = BlockOutput(
            frames=frames,
            frame_valid=frame_valid,
            frame_score=score,
            soft_rms=soft_rms,
            rs_clean=rs_clean,
            packed=packed,
        )
        new_state = PipelineState(chan_tail_i=new_ctail_i, chan_tail_q=new_ctail_q,
                                  fm_prev=fm_state, fir=fir_state, timing=timing_state,
                                  chipbuf=chipbuf, buf_fill=buf_fill,
                                  aux=tuple(aux_state) + ddc_phase + afc_freq)
        return new_state, out
