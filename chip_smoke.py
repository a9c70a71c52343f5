#!/usr/bin/env python
"""Bring-up check: the decode path on one GPU, through its entry points.

Phases, each printing one line of findings:
  (a) device, card name and power limit, host FEC/IQ backends;
  (b) CLI synth -> decode round trip, in this process;
  (c) single-type RS41: 2048 channels x 4 s blocks, bf16 compute, cs16
      ingest, 3 blocks, decode verified against the modulator truth;
  (d) mixed fleet: 2048 PFB bins x 4 s, rs41/m10/dfm mix, pipelined,
      3 blocks + flush, real RS41 and M10 carriers decoded to the truth;
  (e) kernels vs their plain references at real width: the dual-tone
      kernel vs the jnp path, the PFB vs a float64 NumPy channelizer.
With --four, only phase (f) runs: (c) and (d) on a 1-D mesh over 4 cards
against the same work on one card, outputs required identical.

Any failure exits non-zero. The last line of standard output is one JSON
object naming the device; it is printed only when every phase passed.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FS = 48000.0
BLOCK = 192000                  # 4 s at 48 kHz
CHANNELS = 2048
BLOCKS = 3
FLEET_BINS = 2048
RS41_BIN = 1
M10_BIN = 1027                  # an m10 bin of the mix, far from RS41_BIN
KERNEL_CHANNELS = 640           # the fleet's m10 group (614, padded)

# tolerances of the kernel checks, fixed before the first card run:
# the dual-tone metric is a ratio in [-1, 1]; the jnp path's grouped conv
# may run its float32 products in TF32 (10-bit mantissa), so the two
# agree to ~1e-3 where the tone envelopes are not both near zero
DUALTONE_METRIC_TOL = 2e-2
DUALTONE_AFC_RAD_TOL = 1e-3
# relative RMS error of the PFB vs float64: float32 operands run the DFT
# einsums in TF32 on the card (2^-11 per rounding, a few stages); bf16
# fleets store every stage in bf16 (2^-8 per rounding)
PFB_TOL = {"f32": 3e-3, "bf16": 1.5e-2}


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def rs41_iq(seconds: int, snr_db: float, seed: int) -> np.ndarray:
    from sondetpu.sondes.modulate import add_awgn
    from sondetpu.sondes.rs41 import SPEC, RS41Modulator, RS41Truth

    n = int(np.ceil(seconds * SPEC.baud / (8 * SPEC.frame_bytes))) + 1
    iq = RS41Modulator().modulate([RS41Truth(frame_no=i) for i in range(n)],
                                  fs=FS)
    return add_awgn(iq, snr_db, rng=np.random.default_rng(seed))


def m10_iq(seconds: int) -> np.ndarray:
    from sondetpu.sondes.m10 import M10Modulator, M10Truth

    mod = M10Modulator()
    per_frame = mod.modulate([M10Truth()]).size / FS
    n = int(np.ceil(seconds / per_frame)) + 1
    return mod.modulate([M10Truth(frame_no=i) for i in range(n)])


# ---------------------------------------------------------------- phases

def phase_device():
    import jax
    from sondetpu.fec import native
    from sondetpu.io.iq import _load_native

    devs = jax.devices()
    d0 = devs[0]
    say("a", platform=d0.platform, kind=repr(d0.device_kind),
        count=len(devs))
    if d0.platform != "gpu":
        fail(f"no GPU: JAX found {d0.platform!r} devices")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"[a] nvidia-smi: {smi}", flush=True)
    say("a", fec="native" if native.available() else "numpy",
        iq="native" if _load_native() else "numpy",
        compile_cache=os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or "<checkout>/.jax_cache")
    return d0


def phase_cli():
    from sondetpu.cli.main import main as cli

    tmp = tempfile.mkdtemp(prefix=".smoke-", dir=HERE)
    try:
        iq = os.path.join(tmp, "x.cf32")
        jl = os.path.join(tmp, "out.jsonl")
        with contextlib.redirect_stdout(io.StringIO()):
            if cli(["synth", "--sonde", "rs41", "--frames", "8",
                    "--snr", "10", "--out", iq]):
                fail("cli synth returned non-zero")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli(["decode", "--iq", iq, "--sonde", "rs41",
                      "--jsonl", jl])
        if rc:
            fail(f"cli decode returned {rc}")
        m = json.loads(err.getvalue().strip().splitlines()[-1])
        with open(jl) as f:
            last = json.loads(f.read().strip().splitlines()[-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("b", frames_raw=m["frames_raw"], frames_decoded=m["frames_decoded"],
        serial=last.get("serial"))
    if not (m["frames_raw"] > 0 and m["frames_decoded"] == m["frames_raw"]):
        fail(f"cli decode: {m['frames_decoded']}/{m['frames_raw']} frames")
    if last.get("serial") != "S1234567":
        fail(f"cli decode serial {last.get('serial')!r}")


def rs41_blocks(channels: int):
    """BLOCKS blocks of cs16-quantised noisy RS41 IQ, the same stream on
    every channel (host int16 planes [channels, BLOCK])."""
    iq = rs41_iq(BLOCKS * BLOCK // int(FS), snr_db=17.0, seed=SEED)
    out = []
    for b in range(BLOCKS):
        blk = iq[b * BLOCK:(b + 1) * BLOCK]
        qi = np.clip(blk.real * 32767, -32768, 32767).astype(np.int16)
        qq = np.clip(blk.imag * 32767, -32768, 32767).astype(np.int16)
        out.append((np.ascontiguousarray(np.broadcast_to(qi, (channels, BLOCK))),
                    np.ascontiguousarray(np.broadcast_to(qq, (channels, BLOCK)))))
    return out


def run_rs41(mesh=None, phase="c", dev=None):
    """Full-width single-type decode through DecoderSession; returns (the
    packed readback per block, telemetry per channel)."""
    import jax
    from sondetpu.runtime.pipeline import PipelineConfig
    from sondetpu.runtime.session import DecoderSession

    cfg = PipelineConfig(sonde="rs41", channels=CHANNELS, block_len=BLOCK,
                         compute_dtype="bf16", input_dtype="i16")
    sess = DecoderSession(cfg, mesh=mesh)
    blocks = rs41_blocks(CHANNELS)
    if mesh is None:
        spec = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype),
            (sess.state, blocks[0][0], blocks[0][1]))
        t0 = time.perf_counter()
        compiled = sess.pipeline._step.lower(*spec).compile()
        say(phase, compile_s=f"{time.perf_counter() - t0:.1f}",
            memory_analysis=str(compiled.memory_analysis()).replace("\n", " "))
    grab = _packed_tap({"rs41": (list(range(CHANNELS)), sess)})
    walls, decoded = [], []
    for qi, qq in blocks:
        before = sess.metrics.frames_decoded
        t0 = time.perf_counter()
        sess.process_block((qi, qq))
        walls.append(time.perf_counter() - t0)
        decoded.append(sess.metrics.frames_decoded - before)
    total = sum(decoded)
    telem = sess.telemetry
    say(phase, blocks=len(blocks), frames_decoded=decoded,
        per_channel=total / CHANNELS,
        block_wall_s=[f"{w:.2f}" for w in walls],
        peak_bytes=None if dev is None else peak_bytes(dev))
    if total == 0 or any(d % CHANNELS for d in decoded):
        fail(f"rs41: non-uniform or empty decode {decoded}")
    bad = [ch for ch in range(CHANNELS)
           if ch not in telem or telem[ch].serial != "S1234567"
           or abs(telem[ch].lat - 45.0) > 1e-4
           or abs(telem[ch].lon - 9.0) > 1e-4
           or abs(telem[ch].alt - 12000.0) > 1.0]
    if bad:
        fail(f"rs41: telemetry differs from the truth on {len(bad)} "
             f"channels (first {bad[0]})")
    return grab(), _telem(telem)


def _telem(telem):
    return {ch: (t.serial, t.lat, t.lon, t.alt, t.seq)
            for ch, t in telem.items()}


def fleet_channels(mesh_sizes: bool):
    """The bench mix (~60% rs41, ~30% m10, rest dfm, every bin occupied);
    with mesh_sizes, two dfm bins turn rs41 and m10 so every group size
    divides 4 (1232/616/200)."""
    from sondetpu.runtime.fleet import FleetChannel

    chans = []
    for k in range(FLEET_BINS):
        sonde = "rs41" if k % 10 < 6 else ("m10" if k % 10 < 9 else "dfm")
        if mesh_sizes and k in (9, 19, 29, 39):
            sonde = "rs41" if k in (9, 19) else "m10"
        chans.append(FleetChannel(pfb_bin=k, sonde=sonde))
    return chans


def fleet_blocks():
    """Device-resident wideband blocks: an RS41 carrier in RS41_BIN and an
    M10 carrier in M10_BIN (linearly interpolated from 48 kHz, whose images
    in the other bins sit below the noise, and shifted onto their bins),
    plus white noise; made on the device from SEED."""
    import jax
    import jax.numpy as jnp

    n = FLEET_BINS
    w = n * BLOCK
    secs = BLOCKS * BLOCK // int(FS)
    rs = rs41_iq(secs, snr_db=30.0, seed=SEED + 1)
    mt = m10_iq(secs)

    @jax.jit
    def make(a_i, a_q, b_i, b_q, key):
        t = jnp.arange(w, dtype=jnp.int32) % n
        frac = t.astype(jnp.float32) / n

        def up(x):              # BLOCK + 1 samples -> w, linear
            return (jnp.repeat(x[:-1], n) * (1.0 - frac)
                    + jnp.repeat(x[1:], n) * frac)

        def carrier(x_i, x_q, k):
            ph = 2.0 * jnp.pi * ((t * k) % n).astype(jnp.float32) / n
            c, s = jnp.cos(ph), jnp.sin(ph)
            x_i, x_q = up(x_i), up(x_q)
            return x_i * c - x_q * s, x_i * s + x_q * c

        ri, rq = carrier(a_i, a_q, RS41_BIN)
        mi, mq = carrier(b_i, b_q, M10_BIN)
        ki, kq = jax.random.split(key)
        return (ri + mi + 0.05 * jax.random.normal(ki, (w,)),
                rq + mq + 0.05 * jax.random.normal(kq, (w,)))

    key = jax.random.key(SEED)
    out = []
    for b in range(BLOCKS):
        sl = slice(b * BLOCK, (b + 1) * BLOCK + 1)
        key, sub = jax.random.split(key)
        out.append(make(rs[sl].real.astype(np.float32),
                        rs[sl].imag.astype(np.float32),
                        mt[sl].real.astype(np.float32),
                        mt[sl].imag.astype(np.float32), sub))
    return out


def run_fleet(mesh=None, phase="d", dev=None, mesh_sizes=False):
    """Full-width mixed fleet; returns (packed bytes per block, telemetry)."""
    import jax
    from sondetpu.runtime.fleet import FleetSession

    fleet = FleetSession(fleet_channels(mesh_sizes), n_bins=FLEET_BINS,
                         fs_chan=FS, block_len=BLOCK, pipelined=True,
                         compute_dtype="bf16", mesh=mesh)
    sizes = {s: len(i) for s, (i, _) in fleet.groups.items()}
    kern = sorted(s for s, (_, ss) in fleet.groups.items()
                  if ss.pipeline._kernel)
    blocks = fleet_blocks()
    jax.block_until_ready(blocks)
    if mesh is None:
        t0 = time.perf_counter()
        compiled = fleet._fused_step.lower(
            fleet.pfb_state, fleet._states, *blocks[0]).compile()
        say(phase, compile_s=f"{time.perf_counter() - t0:.1f}",
            memory_analysis=str(compiled.memory_analysis()).replace("\n", " "))
    packed, walls, updates = [], [], 0
    grab = _packed_tap(fleet.groups)
    for wi, wq in blocks:
        t0 = time.perf_counter()
        updates += fleet.process_wideband((wi, wq))
        walls.append(time.perf_counter() - t0)
    updates += fleet.flush()
    telem = fleet.telemetry
    say(phase, groups=sizes, kernel_groups=kern, updates=updates,
        block_wall_s=[f"{w:.2f}" for w in walls],
        peak_bytes=None if dev is None else peak_bytes(dev))
    if updates <= 0:
        fail("fleet: no telemetry updates")
    for ch, serial, lat in ((RS41_BIN, "S1234567", 45.0),
                            (M10_BIN, "910-2-12345", 52.2)):
        t = telem.get(ch)
        if t is None or t.serial != serial or abs(t.lat - lat) > 1e-4:
            fail(f"fleet: bin {ch} decoded {None if t is None else t.serial!r}"
                 f", want {serial!r}")
    return grab(), _telem(telem)


def _packed_tap(groups):
    """Record what every session of ``groups`` ({sonde: (idxs, session)})
    reads back, per group and block: (frames, valid, rs_clean, soft_rms)
    of its real channels (pad channels dropped)."""
    from sondetpu.runtime.pipeline import unpack_block_output

    seen = {}
    for sonde, (idxs, sess) in groups.items():
        real = sess._handle_output

        def tap(out, _s=sonde, _n=len(idxs), _sess=sess, _real=real):
            c = _sess.config
            host = np.concatenate([p for _, p in _sess._packed_parts(out)])
            parts = unpack_block_output(host, c.k_slots, c.wire_ncols,
                                        c.chase_total)
            seen.setdefault(_s, []).append(tuple(x[:_n] for x in parts))
            return _real(out)

        sess._handle_output = tap
    return lambda: seen


def _same_outputs(a, b) -> bool:
    """Per group and block: validity identical; the frames, RS verdicts and
    weak-bit lists of the valid slots identical (an empty slot's bytes are
    whatever the noise gave); soft_rms (a float mean the two layouts may
    sum in another order) equal to 1e-4 relative."""
    if a.keys() != b.keys():
        return False
    for s in a:
        if len(a[s]) != len(b[s]):
            return False
        for pa, pb in zip(a[s], b[s]):
            va, vb = pa[1], pb[1]
            if not np.array_equal(va, vb):
                return False
            for k in (0, 2) + ((4,) if len(pa) > 4 else ()):
                if not np.array_equal(pa[k][va], pb[k][vb]):
                    return False
            if not np.allclose(pa[3], pb[3], rtol=1e-4, atol=1e-6):
                return False
    return True


def phase_kernels(dev):
    """(e) every kernel of the path on the card vs its plain reference."""
    import jax
    import jax.numpy as jnp
    from sondetpu.dsp.channelizer import PFBChannelizer, reference_channelize
    from sondetpu.runtime.pipeline import Pipeline, PipelineConfig

    # dual-tone kernel vs the jnp dual-tone path: the m10 group of the
    # fleet cell (614 channels padded to 640) x 4 s, float32 planes of a
    # noisy m10 signal with a 300 Hz carrier offset, zero history
    cfg = PipelineConfig(sonde="m10", channels=KERNEL_CHANNELS,
                         block_len=BLOCK,
                         afc=True, use_pallas=True)
    pipe = Pipeline(cfg)
    sig = m10_iq(BLOCK // int(FS) + 1)[:BLOCK]
    sig = sig * np.exp(2j * np.pi * 300.0 * np.arange(BLOCK) / FS)
    key_i, key_q = jax.random.split(jax.random.key(SEED + 2))
    ii = jnp.asarray(sig.real, jnp.float32)[None] + 0.3 * jax.random.normal(
        key_i, (cfg.channels, BLOCK))
    qq = jnp.asarray(sig.imag, jnp.float32)[None] + 0.3 * jax.random.normal(
        key_q, (cfg.channels, BLOCK))
    st = pipe.init_state()
    kern = jax.jit(pipe._fused_dualtone)
    xla = jax.jit(pipe._dualtone_xla)
    k_out = kern(ii, qq, jnp.asarray(st.chan_tail_i), jnp.asarray(st.chan_tail_q))
    x_out = xla(jnp.asarray(st.fir.tail), ii, qq)
    met_err = float(jnp.max(jnp.abs(k_out[0] - x_out[0])))
    ang_k = jnp.arctan2(k_out[5], k_out[4])
    ang_x = jnp.arctan2(x_out[2][1], x_out[2][0])
    afc_err = float(jnp.max(jnp.abs(ang_k - ang_x)))
    say("e", kernel="dualtone", shape=(cfg.channels, BLOCK),
        precision="f32 in-kernel vs jnp (conv at default precision)",
        metric_max_abs_err=f"{met_err:.2e}", tol=DUALTONE_METRIC_TOL,
        afc_angle_max_err_rad=f"{afc_err:.2e}", afc_tol=DUALTONE_AFC_RAD_TOL)
    if not (met_err <= DUALTONE_METRIC_TOL and afc_err <= DUALTONE_AFC_RAD_TOL):
        fail("dual-tone kernel differs from the jnp path")

    # PFB (XLA: slice-sum FIR + mixed-radix DFT einsums) vs float64 NumPy
    rng = np.random.default_rng(SEED + 3)
    m_out = 512
    x = (rng.normal(size=FLEET_BINS * m_out)
         + 1j * rng.normal(size=FLEET_BINS * m_out))
    for dt in ("f32", "bf16"):
        pfb = PFBChannelizer(FLEET_BINS, dtype=dt)
        _, yi, yq = pfb(pfb.init_state(), x.real.astype(np.float32),
                        x.imag.astype(np.float32))
        y = np.asarray(yi, np.float64) + 1j * np.asarray(yq, np.float64)
        ref = reference_channelize(pfb._hbank, x)
        rel = float(np.sqrt(np.mean(np.abs(y - ref) ** 2)
                            / np.mean(np.abs(ref) ** 2)))
        say("e", kernel=f"pfb_{dt}", n=FLEET_BINS, m_out=m_out,
            rel_rms_err=f"{rel:.2e}", tol=PFB_TOL[dt])
        if rel > PFB_TOL[dt]:
            fail(f"PFB {dt} differs from the float64 reference")
    say("e", peak_bytes=peak_bytes(dev))


def phase_four():
    """(f) (c) and (d) on a 1-D mesh over 4 cards vs one card."""
    import jax
    from sondetpu.parallel import make_mesh

    devs = jax.devices()
    if len(devs) != 4:
        fail(f"--four needs 4 devices, JAX found {len(devs)}")
    mesh = make_mesh()
    # the one-card reference runs on a 1-device mesh: the same global
    # shapes (no group padding) and the same step code as the 4-card run
    one = make_mesh(devices=devs[:1])
    p1, t1 = run_rs41(mesh=one, phase="f")
    p4, t4 = run_rs41(mesh=mesh, phase="f")
    same = _same_outputs(p1, p4) and t1 == t4
    say("f", cell="rs41", outputs_identical=same)
    if not same:
        fail("rs41: sharded outputs differ from one card")
    f1, u1 = run_fleet(mesh=one, phase="f", mesh_sizes=True)
    f4, u4 = run_fleet(mesh=mesh, phase="f", mesh_sizes=True)
    same = _same_outputs(f1, f4) and u1 == u4
    say("f", cell="fleet", outputs_identical=same,
        peak_bytes_per_card=[peak_bytes(d) for d in devs])
    if not same:
        fail("fleet: sharded outputs differ from one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh phase (f)")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    from sondetpu.compile_cache import use_compile_cache

    use_compile_cache()
    t_all = time.perf_counter()
    dev = phase_device()
    if args.four:
        phase_four()
    else:
        phase_cli()
        run_rs41(dev=dev)
        run_fleet(dev=dev)
        phase_kernels(dev)
    import jax

    print(f"[done] wall_s={time.perf_counter() - t_all:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
