#!/usr/bin/env python
"""Time the fused dual-tone kernel against the jnp path on one GPU.

Three comparisons, each run in turns (jnp, kernel, kernel, jnp) inside
this one process, reported as the median of steady-state iterations:

  front end  the dual-tone stage alone (kernel vs _dualtone_xla) at the
             mixed-fleet m10 group shape, 640 channels x 4 s, bf16 planes,
             plus the kernel's tile sweep;
  group      the whole m10 group step (Pipeline._step) at that shape;
  fleet      the fused fleet step at 2048 PFB bins x 4 s, bench mix, bf16.

Usage: python tools/dualtone_ab.py [--iters N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCK = 192000
M10_CHANNELS = 640
TILES = [(1, 1024, 4), (2, 512, 4), (4, 512, 4), (2, 1024, 4),
         (4, 1024, 8), (8, 256, 4), (1, 2048, 8)]


def timed(fn, iters):
    """Median and quartiles (ms) of fn() over iters calls after 2 warm-ups;
    fn returns what to block on."""
    import jax

    for _ in range(2):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    return {"median_ms": round(float(med), 3), "q1_ms": round(float(q1), 3),
            "q3_ms": round(float(q3), 3), "n": iters}


def ab(label, fns, iters):
    """fns = {"jnp": f, "kernel": g}: run jnp, kernel, kernel, jnp."""
    res = {k: [] for k in fns}
    for k in ("jnp", "kernel", "kernel", "jnp"):
        res[k].append(timed(fns[k], iters))
    out = {k: v for k, v in res.items()}
    print(json.dumps({"cmp": label, **out}), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    from sondetpu.compile_cache import use_compile_cache

    use_compile_cache()
    import functools
    import jax
    import jax.numpy as jnp
    from sondetpu.pallas import dualtone
    from sondetpu.runtime.pipeline import Pipeline, PipelineConfig

    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        print(f"no GPU: {d0.platform}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": d0.device_kind, "nvidia_smi": smi}))

    key = jax.random.key(0)
    ki, kq = jax.random.split(key)
    shape = (M10_CHANNELS, BLOCK)
    ii = (0.5 * jax.random.normal(ki, shape)).astype(jnp.bfloat16)
    qq = (0.5 * jax.random.normal(kq, shape)).astype(jnp.bfloat16)

    pipes = {k: Pipeline(PipelineConfig(
        sonde="m10", channels=M10_CHANNELS, block_len=BLOCK,
        compute_dtype="bf16", use_pallas=k == "kernel"))
        for k in ("jnp", "kernel")}
    pk = pipes["kernel"]
    st_k = pk.init_state()
    st_x = pipes["jnp"].init_state()
    tail_i = jnp.asarray(st_k.chan_tail_i)
    tail_q = jnp.asarray(st_k.chan_tail_q)
    fir_tail = jnp.asarray(st_x.fir.tail)

    # the front-end stage alone, and the kernel's tile sweep
    xla_fe = jax.jit(pipes["jnp"]._dualtone_xla)
    sweep = {}
    for tile in TILES:
        fn = jax.jit(functools.partial(
            dualtone.fused_dualtone_frontend,
            chan_taps=tuple(map(float, pk._chan_taps)),
            box=tuple(map(float, pk._box)),
            dev_over_fs=float(pk._dev) / float(pk.config.fs_proc),
            skip_chanfilt=pk._skip_chanfilt, tile=tile))
        sweep[str(tile)] = timed(lambda: fn(ii, qq, tail_i, tail_q),
                                 args.iters)
        print(json.dumps({"tile": tile, **sweep[str(tile)]}), flush=True)
    best = min(sweep, key=lambda t: sweep[t]["median_ms"])
    print(json.dumps({"best_tile": best}), flush=True)
    kern_fe = jax.jit(pk._fused_dualtone)
    ab("front_end", {"jnp": lambda: xla_fe(fir_tail, ii, qq),
                     "kernel": lambda: kern_fe(ii, qq, tail_i, tail_q)},
       args.iters)

    # the whole m10 group step (state threaded through, as in a stream)
    states = {k: p.init_state() for k, p in pipes.items()}

    def group(k):
        def f():
            states[k], out = pipes[k]._step(states[k], ii, qq)
            return out.packed
        return f

    ab("m10_group_step", {k: group(k) for k in pipes}, args.iters)

    # the fused fleet step at 2048 bins x 4 s (the smoke test's cell)
    from sondetpu.runtime.fleet import FleetChannel, FleetSession

    n_bins = 2048
    chans = [FleetChannel(pfb_bin=k, sonde="rs41" if k % 10 < 6 else
                          ("m10" if k % 10 < 9 else "dfm"))
             for k in range(n_bins)]
    w = n_bins * BLOCK
    wi = 0.1 * jax.random.normal(ki, (w,))
    wq = 0.1 * jax.random.normal(kq, (w,))
    fleets = {k: FleetSession(chans, n_bins=n_bins, block_len=BLOCK,
                              compute_dtype="bf16",
                              use_pallas=k == "kernel")
              for k in ("jnp", "kernel")}
    fstate = {k: (f.pfb_state, f._states) for k, f in fleets.items()}

    def fleet(k):
        def f():
            ps, sts = fstate[k]
            ps, sts, packed, _ = fleets[k]._fused_step(ps, sts, wi, wq)
            fstate[k] = (ps, sts)
            return packed
        return f

    ab("fleet_step", {k: fleet(k) for k in fleets}, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
