#!/usr/bin/env python
"""Per-stage device cost of the decode pipeline via stop-after ablation.

Compiles the step truncated after each successive stage
(PipelineConfig.profile_stop) and times a queued run of each; consecutive
differences are per-stage device milliseconds. Each timing ends in a tiny
scalar readback.

Usage: python tools/profile_stages.py [channels] [block_secs] [sonde]
(SONDETPU_PALLAS=1 profiles the dual-tone kernel path of the dual-tone
families)

RELIABILITY: the front-end stage diffs (chanfilt, demod,
timing, sample) are trustworthy; the TAIL truncations (corr/peaks/gather/
syndrome) are NOT — a truncated program that materializes + sums the
correlation lowers differently from the full program (seconds vs the full
step's tens of ms), so their diffs go wildly negative against FULL. For
tail-stage attribution use feature toggles on the full step instead
(pop spec.extra['rs'] / ['wire_columns'] and re-measure).
"""

import os
import sys
import time

import numpy as np

# repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ["chanfilt", "demod", "timing", "sample", "corr", "peaks",
          "gather", "syndrome", None]


def main():
    import jax
    from sondetpu.compile_cache import use_compile_cache

    use_compile_cache()

    from sondetpu.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu.sondes.base import get_sonde

    channels = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    block_secs = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    sonde = sys.argv[3] if len(sys.argv) > 3 else "rs41"
    block_len = 48000 * block_secs

    # representative modulated signal (the family's own truth class)
    from sondetpu.cli.main import _truth_class
    fam = get_sonde(sonde)
    mod = fam["modulator"]()
    cls = _truth_class(sonde)
    truths = []
    for i in range(2 * block_secs + 1):
        t = cls()
        if hasattr(t, "frame_no"):
            t.frame_no = i
        truths.append(t)
    iq1 = np.asarray(mod.modulate(truths, fs=48000.0))
    iq1 = np.tile(iq1, -(-block_len // iq1.size))[:block_len]
    rng = np.random.default_rng(0)
    noisy = iq1 + (rng.normal(size=iq1.shape) + 1j * rng.normal(size=iq1.shape)
                   ).astype(np.complex64) * 0.1
    iq_i = jax.device_put(np.tile(noisy.real.astype(np.float32)[None, :],
                                  (channels, 1)))
    iq_q = jax.device_put(np.tile(noisy.imag.astype(np.float32)[None, :],
                                  (channels, 1)))

    n_iter = 8
    prev_ms = 0.0
    print(f"{'stage':>10} {'cum_ms':>9} {'stage_ms':>9}")
    for stage in STAGES:
        cfg = PipelineConfig(sonde=sonde, channels=channels,
                             block_len=block_len, profile_stop=stage,
                             use_pallas=bool(int(os.environ.get(
                                 "SONDETPU_PALLAS", "0"))),
                             compute_dtype="bf16" if int(os.environ.get(
                                 "SONDETPU_BF16", "0")) else "f32")
        pipe = Pipeline(cfg)
        state0 = pipe.init_state()
        # per-iteration min: one slow iteration poisons a mean (negative
        # stage diffs)
        ts = []
        if stage is None:
            state, out = pipe.step(state0, (iq_i, iq_q))
            np.asarray(out.soft_rms)
            for _ in range(n_iter):
                t0 = time.perf_counter()
                state, out = pipe.step(state, (iq_i, iq_q))
                np.asarray(out.soft_rms)
                ts.append(time.perf_counter() - t0)
        else:
            out = pipe.step(state0, (iq_i, iq_q))
            np.asarray(out)
            for _ in range(n_iter):
                t0 = time.perf_counter()
                out = pipe.step(state0, (iq_i, iq_q))
                np.asarray(out)
                ts.append(time.perf_counter() - t0)
        ms = min(ts) * 1e3
        print(f"{stage or 'FULL':>10} {ms:9.2f} {ms - prev_ms:9.2f}",
              flush=True)
        prev_ms = ms


if __name__ == "__main__":
    main()
