"""Frame synchronization: syncword correlation, peak picking, frame gather.

Batched re-design of sondedump's frame-sync correlator (SURVEY.md S0,
BASELINE.json:5 "frame-sync correlator"). Soft symbols are correlated
against the +/-1 syncword template with a batched convolution;
peaks are selected with an iterative argmax + neighborhood-suppression loop
of static depth; frames are gathered at the peak offsets into fixed-capacity
slots with a validity mask (SURVEY.md §7 "ragged outputs" strategy), keeping
every shape static for XLA.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from sondetpu.sync.coding import np_bytes_to_bits


def syncword_to_chips(syncword: bytes, lsb_first: bool = False) -> np.ndarray:
    """Convert a syncword byte string to a +/-1 float32 chip template."""
    bits = np_bytes_to_bits(np.frombuffer(syncword, dtype=np.uint8), lsb_first)
    return (bits.astype(np.float32) * 2.0 - 1.0)


def correlate_syncword(soft: jax.Array, template: jax.Array) -> jax.Array:
    """Correlate soft symbols [channels, n] against template [L].

    Returns corr [channels, n - L + 1]; corr[c, i] = sum_k soft[c, i+k]*t[k],
    normalized so a perfect hard match scores 1.0.
    """
    from sondetpu.dsp.fir import _conv1d

    template = jnp.asarray(template, jnp.float32)
    return _conv1d(soft, template) / template.shape[0]


def find_frame_starts(corr: jax.Array, threshold: float, max_peaks: int,
                      min_distance: int):
    """Pick up to ``max_peaks`` correlation peaks per channel.

    Two-level search: a max pass reduces the full correlation to per-half-
    window block candidates, then the iterative argmax + +/-``min_distance``
    suppression loop runs on the tiny candidate set, instead of
    suppressing on the full array (each suppression round would re-read
    the whole [C, n] buffer). The TOP-2 of each block are kept as candidates:
    with only the block max, a peak could be shadowed by a larger
    same-block value that was itself suppressed by a third, even larger
    peak — the runner-up covers that single-shadow case (deeper shadowing
    needs three above-threshold peaks inside 1.5 min_distance, which real
    frames, spaced >= 4 min_distance, cannot produce).
    Returns (starts [C, K] int32 sorted ascending, ok [C, K] bool).
    """
    c, n = corr.shape
    half = max(min_distance // 2, 1)
    nb = -(-n // half)
    cp = jnp.pad(corr, ((0, 0), (0, nb * half - n)),
                 constant_values=-jnp.inf)
    blocks = cp.reshape(c, nb, half)
    a1 = jnp.argmax(blocks, axis=-1)                        # [C, nb]
    v1 = jnp.max(blocks, axis=-1)
    masked = jnp.where(jax.nn.one_hot(a1, half, dtype=bool), -jnp.inf, blocks)
    a2 = jnp.argmax(masked, axis=-1)
    v2 = jnp.max(masked, axis=-1)
    base = half * jnp.arange(nb)[None, :]
    cand_v = jnp.concatenate([v1, v2], axis=-1)             # [C, 2*nb]
    cand_p = jnp.concatenate([a1 + base, a2 + base], axis=-1)
    idxs = []
    oks = []
    work = cand_v
    for _ in range(max_peaks):
        j = jnp.argmax(work, axis=-1)                       # [C]
        v = jnp.take_along_axis(work, j[:, None], axis=-1)[:, 0]
        p = jnp.take_along_axis(cand_p, j[:, None], axis=-1)[:, 0]
        idxs.append(p)
        oks.append(v >= threshold)
        # suppress the neighborhood of the found peak
        work = jnp.where(jnp.abs(cand_p - p[:, None]) <= min_distance,
                         -jnp.inf, work)
    starts = jnp.stack(idxs, axis=-1).astype(jnp.int32)    # [C, K]
    ok = jnp.stack(oks, axis=-1)
    # sort by position for deterministic downstream handling
    order = jnp.argsort(jnp.where(ok, starts, n + 1), axis=-1)
    return jnp.take_along_axis(starts, order, axis=-1), jnp.take_along_axis(ok, order, axis=-1)


def gather_frames(stream: jax.Array, starts: jax.Array, ok: jax.Array,
                  frame_len: int):
    """Gather fixed-length frames at per-channel offsets.

    stream: [C, n] (bits or soft symbols); starts/ok: [C, K].
    Returns (frames [C, K, frame_len], valid [C, K]) where valid requires the
    whole frame to fit inside the stream.
    """
    c, n = stream.shape
    k = starts.shape[1]
    fits = starts + frame_len <= n
    valid = ok & fits
    if n < frame_len:
        # a block shorter than one frame can never yield a valid gather;
        # the slice form below would be a trace-time error (slice_sizes
        # exceeding the operand), so short streams return empty directly
        return jnp.zeros((c, k, frame_len), stream.dtype), valid & False
    safe = jnp.clip(starts, 0, max(n - frame_len, 0))
    # ONE contiguous slice per (channel, slot) via lax.gather slice_sizes
    # rather than an element gather (take_along_axis): at fleet scale the
    # m10 group gathers 3.5M elements per block, and a slice per slot moves
    # them as contiguous runs
    rows = jnp.broadcast_to(jnp.arange(c, dtype=jnp.int32)[:, None], (c, k))
    idx = jnp.stack([rows, safe.astype(jnp.int32)], axis=-1).reshape(c * k, 2)
    frames = jax.lax.gather(
        stream, idx,
        jax.lax.GatherDimensionNumbers(offset_dims=(1,),
                                       collapsed_slice_dims=(0,),
                                       start_index_map=(0, 1)),
        slice_sizes=(1, frame_len)).reshape(c, k, frame_len)
    return frames, valid
