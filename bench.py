#!/usr/bin/env python
"""Headline benchmark: concurrent real-time RS41 channels per chip.

Runs the full jitted decode pipeline (FM demod -> matched filter -> timing
-> slicer -> syncword correlator -> frame gather) on real hardware over a
large channel batch and measures sustained throughput.

Metric: rs41_realtime_channels_per_chip — how many 48 kHz RS41 channels one
chip decodes in real time (channels * block_seconds / step_wall_seconds).

vs_baseline: value / 62.5, the per-device share of the origin target of
>=1000 channels over 16 devices (BASELINE.json:5).

Runs only on a GPU: without one it exits non-zero. Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "detail"}; detail names the
device (platform, device_kind, count, card name and power limit).
"""

import json
import os
import sys
import time

import numpy as np


def _device_detail():
    """The device the numbers were taken on; exits unless it is a GPU."""
    import subprocess
    import jax
    from sondetpu.compile_cache import use_compile_cache

    use_compile_cache()
    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {d0.platform!r}",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    name, limit = [x.strip() for x in smi.splitlines()[0].split(",")]
    return {"platform": d0.platform, "device_kind": d0.device_kind,
            "device_count": len(jax.devices()), "card": name,
            "power_limit": limit}


def bench_fleet():
    """Mixed-fleet wideband benchmark (BASELINE.json configs[5]: "1000+
    heterogeneous channels"): one PFB channelizer + three per-type batched
    pipelines (rs41/m10/dfm) over a device-resident wideband block.
    Measures the sustained device rate of the full fleet step — PFB,
    per-group bin gathers, and every group's decode front end — with the
    per-group packed readbacks on the wire each block (ingest itself is an
    SDR-side concern; the block is uploaded once and re-fed).

    Usage: python bench.py fleet [n_bins] [block_secs]
    """
    import jax
    device = _device_detail()

    from sondetpu.runtime.fleet import FleetChannel, FleetSession
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth

    n_bins = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    block_secs = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    fs_chan = 48000.0
    block_len = int(48000 * block_secs)
    w = n_bins * block_len

    # heterogeneous map: ~60% rs41, ~30% m10, rest dfm (every bin occupied)
    chans = []
    for k in range(n_bins):
        sonde = "rs41" if k % 10 < 6 else ("m10" if k % 10 < 9 else "dfm")
        chans.append(FleetChannel(pfb_bin=k, sonde=sonde))
    counts = {}
    for c in chans:
        counts[c.sonde] = counts.get(c.sonde, 0) + 1

    # dual-tone groups take the fused kernel on a GPU (FleetSession's
    # default), NRZ/AFSK groups the jnp path
    cdt = "bf16" if int(os.environ.get("SONDETPU_BF16", "1")) else "f32"
    fleet = FleetSession(chans, n_bins=n_bins, fs_chan=fs_chan,
                         block_len=block_len, pipelined=True,
                         compute_dtype=cdt)

    # wideband block: noise + one real RS41 carrier (zero-order-hold
    # upsampled into bin 1) so the datapath sees a representative signal
    rng = np.random.default_rng(0)
    mod = RS41Modulator()
    nb = mod.modulate([RS41Truth(frame_no=i) for i in range(2 * block_secs + 1)],
                      fs=fs_chan)[:block_len]
    k_bin = 1
    ph = np.exp(2j * np.pi * k_bin * np.arange(w) / n_bins).astype(np.complex64)
    wide = np.repeat(nb, n_bins)[:w] * ph
    wi = (wide.real + rng.normal(size=w, scale=0.05)).astype(np.float32)
    wq = (wide.imag + rng.normal(size=w, scale=0.05)).astype(np.float32)
    del wide, ph
    wi = jax.device_put(wi)
    wq = jax.device_put(wq)

    # warmup/compile (PFB + every group's pipeline)
    for _ in range(2):
        fleet.process_wideband((wi, wq))

    iters = 6
    times = []
    updates = 0
    for _ in range(iters):
        t0 = time.perf_counter()
        updates += fleet.process_wideband((wi, wq))
        times.append(time.perf_counter() - t0)
    updates += fleet.flush()        # drain the pipelined groups' last block
    dt = min(times[1:])

    rt_channels = n_bins * block_secs / dt
    result = {
        "metric": "mixed_fleet_realtime_channels_per_chip",
        "value": round(rt_channels, 1),
        "unit": "channels",
        "vs_baseline": round(rt_channels / 62.5, 3),
        "detail": {
            "n_bins": n_bins,
            "kernel_groups": sorted(s for s, (_, ss) in fleet.groups.items()
                                    if ss.pipeline._kernel),
            "compute_dtype": cdt,
            "mix": counts,
            "wideband_msamples_per_sec": round(w / dt / 1e6, 1),
            "step_ms": round(dt * 1e3, 3),
            "updates": updates,
            **device,
        },
    }
    print(json.dumps(result))


def main():
    import jax
    device = _device_detail()

    from sondetpu.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth

    channels = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    block_secs = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    block_len = 48000 * block_secs   # multi-second blocks amortize the
    fs = 48000.0                     # per-block dispatch + readback

    # bf16 sample storage halves the sample-rate arrays' memory traffic
    # (decode parity with f32 is asserted in the tests)
    cdt = "bf16" if int(os.environ.get("SONDETPU_BF16", "1")) else "f32"
    # i16 ingest (default): raw cs16 planes — the realistic SDR wire format
    # — upload 2x narrower and dequantize on device, where XLA fuses the
    # convert+scale into the channel filter's read
    idt = "i16" if int(os.environ.get("SONDETPU_I16", "1")) else "f32"
    cfg = PipelineConfig(sonde="rs41", channels=channels, block_len=block_len,
                         compute_dtype=cdt, input_dtype=idt)
    pipe = Pipeline(cfg)
    state = pipe.init_state()

    # real modulated signal (so the datapath sees representative values)
    mod = RS41Modulator()
    n_truth = 2 * block_secs + 1
    iq1 = mod.modulate([RS41Truth(frame_no=i) for i in range(n_truth)],
                       fs=fs)[:block_len]
    rng = np.random.default_rng(0)
    noisy = iq1 + (rng.normal(size=iq1.shape) + 1j * rng.normal(size=iq1.shape)
                   ).astype(np.complex64) * 0.1
    # upload as I/Q planes (complex64 stays host-side by design); i16 mode
    # quantizes to the cs16 wire format the SDR would deliver
    if idt == "i16":
        qi = np.clip(noisy.real * 32767, -32768, 32767).astype(np.int16)
        qq = np.clip(noisy.imag * 32767, -32768, 32767).astype(np.int16)
        iq_i = jax.device_put(np.tile(qi[None, :], (channels, 1)))
        iq_q = jax.device_put(np.tile(qq[None, :], (channels, 1)))
    else:
        iq_i = jax.device_put(np.tile(noisy.real.astype(np.float32)[None, :],
                                      (channels, 1)))
        iq_q = jax.device_put(np.tile(noisy.imag.astype(np.float32)[None, :],
                                      (channels, 1)))

    # warmup / compile
    state, out = pipe.step(state, (iq_i, iq_q))
    jax.block_until_ready(out)
    state, out = pipe.step(state, (iq_i, iq_q))
    jax.block_until_ready(out)

    iters = 14
    frames_found = 0
    times = []
    prev = None
    for _ in range(iters):
        t0 = time.perf_counter()
        # pipelined streaming loop (runtime/session.py pipelined mode): the
        # next block is dispatched before the previous block's framed output
        # is read, so host readback overlaps device compute
        state, out = pipe.step(state, (iq_i, iq_q))
        if prev is not None:
            # ONE packed readback (wire columns + validity + quality)
            from sondetpu.runtime.pipeline import unpack_block_output
            _, valid, _, _ = unpack_block_output(
                np.asarray(prev.packed), cfg.k_slots, cfg.wire_ncols)
            frames_found += int(valid.sum())
        prev = out
        times.append(time.perf_counter() - t0)
    from sondetpu.runtime.pipeline import unpack_block_output
    _, valid, _, _ = unpack_block_output(np.asarray(prev.packed), cfg.k_slots,
                                         cfg.wire_ncols)
    frames_found += int(valid.sum())
    # minimum over steady-state iterations (iter 0 has no previous block
    # to read, so it measures only dispatch); median and quartiles are the
    # benchmark's job (ROADMAP §A0)
    dt = min(times[1:])

    # ---- decode verification (outside the timed loop) -------------------
    # The headline number must not survive a regression that corrupts bytes
    # AFTER sync: run the final block through the full host FEC/parse path
    # and hold it to the synthetic stream's truth — every channel sees the
    # SAME samples, so the decoded count must be uniform across channels,
    # positive, and the parsed telemetry must match the modulated truth.
    from sondetpu.runtime.session import DecoderSession
    sess = DecoderSession(cfg, pipeline=pipe)   # reuse the compiled pipeline
    updates, frames_raw, decoded, _ = sess._handle_output(prev)
    per_chan = decoded / channels
    ver_err = None
    if decoded == 0:
        ver_err = "no frames decoded"
    elif decoded % channels:
        ver_err = f"non-uniform decode across identical channels: {decoded}"
    else:
        bad = [u for _, u in updates if u.serial != "S1234567"]
        if bad:
            ver_err = f"telemetry mismatch: {bad[0].serial!r}"
    if ver_err is not None:
        print(json.dumps({"metric": "rs41_realtime_channels_per_chip",
                          "value": 0.0, "unit": "channels",
                          "vs_baseline": 0.0,
                          "error": "decode verification failed: " + ver_err}))
        sys.exit(1)

    block_seconds = block_len / fs
    rt_channels = channels * block_seconds / dt
    msps = channels * block_len / dt / 1e6

    result = {
        "metric": "rs41_realtime_channels_per_chip",
        "value": round(rt_channels, 1),
        "unit": "channels",
        "vs_baseline": round(rt_channels / 62.5, 3),
        "detail": {
            "iq_msamples_per_sec_per_chip": round(msps, 2),
            "channels_batched": channels,
            "compute_dtype": cdt,
            "input_dtype": idt,
            "step_ms": round(dt * 1e3, 3),
            "frames_sync": frames_found,
            # full host FEC/parse of the final block, asserted uniform
            # across the identical channels and content-matched vs truth
            "frames_decoded_per_channel": per_chan,
            "decode_verified": True,
            **device,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "fleet":
        bench_fleet()
    else:
        main()
