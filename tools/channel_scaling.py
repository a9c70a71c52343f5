#!/usr/bin/env python
"""Single-card channel-count scaling sweep -> a JSON file.

The throughput-vs-batch curve of the full RS41 step (4 s blocks): how the
fixed dispatch+readback overhead amortizes as the channel batch grows
(SURVEY.md §6 scaling axis).

Usage: python tools/channel_scaling.py [out.json]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHANNELS = [256, 512, 1024, 2048]
BLOCK_SECS = 4
ITERS = 5


def main():
    import jax
    from sondetpu.compile_cache import use_compile_cache

    use_compile_cache()

    from sondetpu.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth

    out_path = sys.argv[1] if len(sys.argv) > 1 else "SCALING.json"
    fs = 48000.0
    block_len = int(fs) * BLOCK_SECS
    mod = RS41Modulator()
    iq1 = mod.modulate([RS41Truth(frame_no=i)
                        for i in range(2 * BLOCK_SECS + 1)], fs=fs)[:block_len]
    rng = np.random.default_rng(0)
    noisy = iq1 + (rng.normal(size=iq1.shape) + 1j * rng.normal(
        size=iq1.shape)).astype(np.complex64) * 0.1
    ri = noisy.real.astype(np.float32)
    rq = noisy.imag.astype(np.float32)

    points = []
    for ch in CHANNELS:
        cfg = PipelineConfig(sonde="rs41", channels=ch, block_len=block_len)
        pipe = Pipeline(cfg)
        state = pipe.init_state()
        iq_i = jax.device_put(np.tile(ri[None, :], (ch, 1)))
        iq_q = jax.device_put(np.tile(rq[None, :], (ch, 1)))
        state, out = pipe.step(state, (iq_i, iq_q))
        np.asarray(out.packed)                 # waits for the device
        times = []
        prev = None
        for _ in range(ITERS):
            t0 = time.perf_counter()
            state, out = pipe.step(state, (iq_i, iq_q))
            if prev is not None:
                np.asarray(prev.packed)        # pipelined readback
            prev = out
            times.append(time.perf_counter() - t0)
        np.asarray(prev.packed)
        dt = min(times[1:])
        points.append({
            "channels": ch,
            "step_ms": round(dt * 1e3, 3),
            "msamples_per_sec": round(ch * block_len / dt / 1e6, 2),
            "rt_channels": round(ch * BLOCK_SECS / dt, 1),
        })
        print(points[-1], file=sys.stderr, flush=True)

    with open(out_path, "w") as f:
        json.dump({"metric": "channel_scaling_4s_blocks",
                   "points": points,
                   "device": str(jax.devices()[0])}, f, indent=1)
    print(f"wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
