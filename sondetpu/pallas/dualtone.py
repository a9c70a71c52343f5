"""Fused dual-tone noncoherent FSK front end: Pallas through Triton.

The jnp dual-tone path (runtime/pipeline.py) mixes the channel by -/+dev,
writes the four mixed planes to device memory, runs one grouped conv over
them for the one-chip boxcar, writes four filtered planes, and reads them
back for the envelope metric. This kernel reads the two input planes once
and writes the metric once.

It rests on one identity. With ang(t) = 2*pi*dev*t/fs linear in t, the
boxcar (taps b[k]) of the plane mixed by e^{-j ang} is

    lp+(t) = sum_k b[k] x~(t-k) e^{-j ang(t-k)}
           = e^{-j ang(t)} * sum_k b[k] e^{+j ang(k)} x~(t-k),

where x~ is the channel-filtered input. The envelope |lp+(t)|^2 drops the
unit-modulus factor, so each tone's envelope is |(G+ * x)(t)|^2 for one
static complex FIR G+ = chan_taps * (b[k] e^{+j ang(k)}) (G- with the
opposite sign). The mixer table, and its large trig arguments, leave the
device: the taps are built in float64 on the host. The AFC discriminant's
adjacent-sample products pick up only a constant phase e^{-/+j ang(1)},
applied to the per-chunk sums.

One program per (channel tile, time chunk), both powers of two. Every tap
is an offset load from device memory (served from L1/L2); the carried
input tail is a second masked load that only chunk 0 touches, and the
block's ragged end is masked, so the input is never padded or copied.
Per-chunk metric sums (mean DC) and AFC rotation sums go out as
[C, nchunks] arrays, reduced in XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# (channel rows, samples, warps) per program: the fastest of a sweep at the
# mixed-fleet m10 group shape (640 x 192000 bf16) on an H100 (PERF.md)
TILE = (2, 1024, 4)


def dualtone_taps(chan_taps, box, dev_over_fs: float, skip_chanfilt: bool):
    """Complex FIRs (G+, G-) of the fused front end, float64, and the
    index of their first nonzero tap.

    ``box`` is the jnp path's boxcar (ntaps long, nonzero at its end, so
    the metric keeps that path's delay); ``chan_taps`` the channel filter,
    skipped for wideband families exactly as the jnp path skips it."""
    box = np.asarray(box, np.float64)
    ph = np.exp(2j * np.pi * float(dev_over_fs) * np.arange(box.size))
    gp, gm = box * ph, box * np.conj(ph)
    if not skip_chanfilt:
        h = np.asarray(chan_taps, np.float64)
        gp, gm = np.convolve(h, gp), np.convolve(h, gm)
    nz = np.nonzero(np.abs(gp) + np.abs(gm))[0]
    k0 = int(nz[0])
    return gp[:nz[-1] + 1], gm[:nz[-1] + 1], k0


def history(chan_taps, box, skip_chanfilt: bool) -> int:
    """Input samples of the previous block the kernel reads: the combined
    FIR's length (its history, plus one for the AFC pair (t, t-1))."""
    return len(box) + (0 if skip_chanfilt else len(chan_taps) - 1)


def _kernel(xi_ref, xq_ref, ti_ref, tq_ref, met_ref, dc_ref, *afc_refs,
            n: int, hist: int, gp, gm, k0: int, rot, tc: int, ck: int):
    c = xi_ref.shape[0]
    r = pl.program_id(0)
    j = pl.program_id(1)
    rows = r * tc + jnp.arange(tc)
    cols = j * ck + jnp.arange(ck)
    row_ok = (rows < c)[:, None]
    want_afc = bool(afc_refs)
    ks = range(k0, len(gp) + (1 if want_afc else 0))

    def sample(k):
        # x(t - k) for t in cols: the block itself, else the carried tail
        s = cols - k
        body = plgpu.load(
            xi_ref.at[rows[:, None], jnp.clip(s, 0, n - 1)[None, :]],
            mask=row_ok & ((s >= 0) & (s < n))[None, :], other=0.0)
        bq = plgpu.load(
            xq_ref.at[rows[:, None], jnp.clip(s, 0, n - 1)[None, :]],
            mask=row_ok & ((s >= 0) & (s < n))[None, :], other=0.0)
        tmask = row_ok & (s < 0)[None, :]
        ts = jnp.clip(s + hist, 0, hist - 1)[None, :]
        ti = plgpu.load(ti_ref.at[rows[:, None], ts], mask=tmask, other=0.0)
        tq = plgpu.load(tq_ref.at[rows[:, None], ts], mask=tmask, other=0.0)
        return (body.astype(jnp.float32) + ti.astype(jnp.float32),
                bq.astype(jnp.float32) + tq.astype(jnp.float32))

    zero = jnp.zeros((tc, ck), jnp.float32)
    # y(t) per tone, and y(t-1) when AFC wants the adjacent-pair products
    yp = [zero, zero]
    ym = [zero, zero]
    yp1 = [zero, zero]
    ym1 = [zero, zero]
    for k in ks:
        xr, xq = sample(k)
        for g, y, d in ((gp, yp, 0), (gm, ym, 0), (gp, yp1, 1), (gm, ym1, 1)):
            if d and not want_afc:
                continue
            kk = k - d
            if kk < k0 or kk >= len(g):
                continue
            gr, gi = float(g[kk].real), float(g[kk].imag)
            if gr == 0.0 and gi == 0.0:
                continue
            y[0] = y[0] + gr * xr - gi * xq
            y[1] = y[1] + gr * xq + gi * xr
    pp = yp[0] * yp[0] + yp[1] * yp[1]
    pm = ym[0] * ym[0] + ym[1] * ym[1]
    met = (pp - pm) / (pp + pm + 1e-12)
    col_ok = (cols < n)[None, :]
    plgpu.store(met_ref.at[rows[:, None], cols[None, :]], met,
                mask=row_ok & col_ok)
    plgpu.store(dc_ref.at[rows, j], jnp.sum(jnp.where(col_ok, met, 0.0),
                                            axis=1), mask=rows < c)
    if want_afc:
        # A = y(t) conj(y(t-1)) per tone, then rot = e^{-j phi} A+ +
        # e^{+j phi} A- (phi = ang(1)); the pair at t == 0 has no
        # predecessor in the block (the jnp path sums t in [1, n))
        cr, sr = rot
        ap_re = yp[0] * yp1[0] + yp[1] * yp1[1]
        ap_im = yp[1] * yp1[0] - yp[0] * yp1[1]
        am_re = ym[0] * ym1[0] + ym[1] * ym1[1]
        am_im = ym[1] * ym1[0] - ym[0] * ym1[1]
        re = cr * ap_re + sr * ap_im + cr * am_re - sr * am_im
        im = cr * ap_im - sr * ap_re + cr * am_im + sr * am_re
        keep = ((cols >= 1) & (cols < n))[None, :]
        rre_ref, rim_ref = afc_refs
        plgpu.store(rre_ref.at[rows, j],
                    jnp.sum(jnp.where(keep, re, 0.0), axis=1), mask=rows < c)
        plgpu.store(rim_ref.at[rows, j],
                    jnp.sum(jnp.where(keep, im, 0.0), axis=1), mask=rows < c)


@functools.partial(jax.jit, static_argnames=(
    "chan_taps", "box", "dev_over_fs", "skip_chanfilt", "want_afc",
    "interpret", "tile"))
def fused_dualtone_frontend(iq_i, iq_q, tail_i, tail_q, *, chan_taps, box,
                            dev_over_fs: float, skip_chanfilt: bool,
                            want_afc: bool = False, interpret: bool = False,
                            tile=TILE):
    """Fused dual-tone front end.

    iq planes [C, n] (any float dtype; arithmetic is float32); tails
    [C, history(...)] raw input carry; ``chan_taps`` and ``box`` as tuples
    of floats (static). Returns (metric [C, n] float32, new_tail_i,
    new_tail_q, dc [C], rot_re [C], rot_im [C]): the raw envelope metric
    (the caller applies mean- or midpoint-DC), its block mean, and the AFC
    envelope-rotation sums (zeros unless ``want_afc``)."""
    c, n = iq_i.shape
    hist = tail_i.shape[-1]
    gp, gm, k0 = dualtone_taps(chan_taps, box, dev_over_fs, skip_chanfilt)
    if hist != history(chan_taps, box, skip_chanfilt) or hist > n:
        raise ValueError(f"tail width {hist} for a block of {n}")
    tc, ck, warps = tile
    nchunks = pl.cdiv(n, ck)
    phi = 2.0 * np.pi * float(dev_over_fs)
    sums = jax.ShapeDtypeStruct((c, nchunks), jnp.float32)
    out_shape = [jax.ShapeDtypeStruct((c, n), jnp.float32), sums]
    if want_afc:
        out_shape += [sums, sums]
    outs = pl.pallas_call(
        functools.partial(_kernel, n=n, hist=hist, gp=gp, gm=gm, k0=k0,
                          rot=(float(np.cos(phi)), float(np.sin(phi))),
                          tc=tc, ck=ck),
        out_shape=out_shape,
        grid=(pl.cdiv(c, tc), nchunks),
        compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="dualtone_frontend",
    )(iq_i, iq_q, tail_i, tail_q)
    metric, dc = outs[0], jnp.sum(outs[1], axis=-1) / n
    if want_afc:
        rre, rim = jnp.sum(outs[2], axis=-1), jnp.sum(outs[3], axis=-1)
    else:
        rre = rim = jnp.zeros((c,), jnp.float32)
    return metric, iq_i[:, -hist:], iq_q[:, -hist:], dc, rre, rim
