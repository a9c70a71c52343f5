#!/usr/bin/env python
"""Per-stage attribution of the mixed-fleet wideband step. Times each
independently-jittable piece of the fused fleet program on the device:

  pfb        — the N-bin polyphase channelizer over the wideband block
  gather:X   — each group's bin gather
  group:X    — each group's compiled front end on its gathered planes
  fused      — the whole fused step (one dispatch)

Usage: python tools/profile_fleet.py [n_bins] [block_secs] [iters]

Reports the minimum over iters of host-clock wall around
block_until_ready; the rows are separate programs, so they need not sum to
the fused step.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sync(out):
    import jax
    jax.block_until_ready(out)


def timeit(fn, *args, iters=5):
    out = fn(*args)
    _sync(out)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    import jax
    import jax.numpy as jnp
    from sondetpu.compile_cache import use_compile_cache

    use_compile_cache()

    from sondetpu.runtime.fleet import FleetChannel, FleetSession

    n_bins = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    block_secs = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    block_len = 48000 * block_secs
    w = n_bins * block_len

    chans = []
    for k in range(n_bins):
        sonde = "rs41" if k % 10 < 6 else ("m10" if k % 10 < 9 else "dfm")
        chans.append(FleetChannel(pfb_bin=k, sonde=sonde))
    cdt = "bf16" if int(os.environ.get("SONDETPU_BF16", "0")) else "f32"
    fleet = FleetSession(chans, n_bins=n_bins, block_len=block_len,
                         pipelined=True, compute_dtype=cdt)
    kern = [s for s, (_, ss) in fleet.groups.items() if ss.pipeline._kernel]
    print(f"config: dual-tone kernel groups={kern} compute_dtype={cdt}")

    rng = np.random.default_rng(0)
    wi = jax.device_put(rng.normal(size=w, scale=0.1).astype(np.float32))
    wq = jax.device_put(rng.normal(size=w, scale=0.1).astype(np.float32))

    rows = []

    # PFB alone
    pfb_state = fleet.pfb.init_state()
    dt = timeit(lambda: fleet.pfb(pfb_state, wi, wq), iters=iters)
    rows.append(("pfb", dt))

    # channelized planes for the group stages
    _, yi, yq = fleet.pfb(pfb_state, wi, wq)
    _sync((yi, yq))

    for sonde, (idxs, sess) in fleet.groups.items():
        g = fleet._gathers[sonde]
        dt = timeit(lambda g=g: g(yi, yq), iters=iters)
        rows.append((f"gather:{sonde}", dt))
        gi, gq = g(yi, yq)
        _sync((gi, gq))
        st = sess.pipeline.init_state()
        step = sess.pipeline._step  # donation: re-init state each call is
        # wrong; use non-donating trace via _step_impl jit-less? simplest:
        # jit without donation
        step_nd = jax.jit(sess.pipeline._step_impl)
        st = jax.block_until_ready(jax.tree.map(jnp.asarray, st))
        dt = timeit(lambda st=st, gi=gi, gq=gq, f=step_nd: f(st, gi, gq),
                    iters=iters)
        rows.append((f"group:{sonde}[{len(idxs)}]", dt))

    # fused whole step (dispatch only, no readback)
    if fleet._fused:
        states = fleet._states

        def fused_once():
            out = fleet._fused_step(fleet.pfb_state, states, wi, wq)
            return out

        # donation: feed back returned states each call
        out = fused_once()
        _sync(out)
        fleet.pfb_state, states_l, packed, frames = out
        ts = []
        states_cur = states_l
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fleet._fused_step(fleet.pfb_state, states_cur, wi, wq)
            _sync(out)
            ts.append(time.perf_counter() - t0)
            fleet.pfb_state, states_cur, packed, frames = out
        rows.append(("fused_total", min(ts)))
        rows.append(("readback_packed", timeit(
            lambda: np.asarray(packed), iters=iters)))

    print(f"{'stage':28s} {'ms':>10s}")
    for name, dt in rows:
        print(f"{name:28s} {dt * 1e3:10.2f}")
    out_path = os.environ.get("SONDETPU_PROFILE_OUT")
    if out_path:
        import json
        with open(out_path, "w") as f:
            json.dump({
                "what": "per-stage wall ms of the fused fleet step",
                "device": jax.devices()[0].device_kind,
                "n_bins": n_bins, "block_secs": block_secs,
                "kernel_groups": kern,
                "compute_dtype": cdt,
                "stages_ms": {name: round(dt * 1e3, 2)
                              for name, dt in rows},
            }, f, indent=1)
        print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
