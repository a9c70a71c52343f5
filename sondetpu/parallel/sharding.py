"""Channel sharding and time-block halo exchange (SURVEY.md §2.4, §5.7).

Channel parallelism: the pipeline state and IQ blocks carry their channel
axis sharded over the mesh ('chip'); the jitted step then runs SPMD with no
collectives (channels are independent — the device analogue of the reference's
"one module instance per sonde", main.cpp:23).

Time/sequence parallelism: long streams split into time blocks across
devices; FIR/correlator boundary state travels to the right neighbor via
``ppermute`` under ``shard_map`` — the DSP analogue of context-parallel halo
exchange (BASELINE.json:5 "overlap-save filter boundaries ... exchanged via
collectives").
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from sondetpu.dsp.fir import _apply_windows


def mesh_channel_axes(mesh: Mesh):
    """The mesh axes the channel dimension shards over: the full
    ('host', 'chip') product on a 2-D multi-host mesh, 'chip' otherwise."""
    names = tuple(mesh.axis_names)
    if "host" in names and "chip" in names:
        return ("host", "chip")
    return names[0]


def channel_spec(leaf: Any, axis="chip") -> P:
    """PartitionSpec sharding the leading (channel) axis of a state leaf.

    ``axis`` may be one mesh axis name or a tuple of names — a 2-D
    ('host', 'chip') mesh shards channels over the host x chip product, so
    host-adjacent channels ride ICI and only telemetry fan-in crosses DCN
    (SURVEY.md §5.8)."""
    ndim = jnp.ndim(leaf)
    return P(axis, *([None] * (ndim - 1)))


# instrumentation: how fleet/session feeds reached the mesh (the 2-process
# fleet test asserts the PFB output takes the device path, not a host copy)
SHARD_STATS = {"host_uploads": 0, "device_feeds": 0}


def shard_channels(tree: Any, mesh: Mesh, axis="chip") -> Any:
    """Place every leaf of a pytree with its channel axis sharded.

    Device-resident leaves (e.g. the fleet PFB output) reshard with
    device_put; host leaves upload. In an N>=2-process run:

    - host (numpy) leaves are GLOBAL-shaped and each process materializes
      only its addressable shards via make_array_from_callback (a plain
      device_put cannot build a non-addressable global array from one
      host);
    - DEVICE-RESIDENT process-local leaves (the fleet's PFB output — every
      process channelizes the same wideband stream locally) stay on
      device: each addressable shard is sliced and placed device-to-device
      and the global array assembled with
      make_array_from_single_device_arrays — no host round trip (VERDICT
      r3 item 9)."""
    multiproc = jax.process_count() > 1

    def put(leaf):
        sh = channel_sharding(leaf, mesh, axis)
        if multiproc and not isinstance(leaf, jax.Array):
            SHARD_STATS["host_uploads"] += 1
            arr = np.asarray(leaf)
            return jax.make_array_from_callback(
                arr.shape, sh, lambda idx, _a=arr: _a[idx])
        if (multiproc and isinstance(leaf, jax.Array)
                and leaf.is_fully_addressable
                and not sh.is_fully_addressable):
            SHARD_STATS["device_feeds"] += 1
            shape = leaf.shape
            pieces = []
            for dev, idx in sh.devices_indices_map(shape).items():
                if dev.process_index != jax.process_index():
                    continue
                pieces.append(jax.device_put(leaf[idx], dev))
            return jax.make_array_from_single_device_arrays(shape, sh, pieces)
        return jax.device_put(leaf, sh)

    return jax.tree.map(put, tree)


def channel_sharding(leaf: Any, mesh: Mesh, axis="chip") -> NamedSharding:
    """The layout shard_channels gives a leaf: leading (channel) axis over
    ``axis`` when it divides the mesh, replicated otherwise."""
    n = mesh.devices.size
    s = np.shape(leaf)
    if len(s) and s[0] >= n and s[0] % n == 0:
        return NamedSharding(mesh, channel_spec(leaf, axis))
    return NamedSharding(mesh, P())


def constrain_channels(tree: Any, mesh: Mesh, axis="chip") -> Any:
    """Inside a jitted step: pin every leaf of a carried state to
    channel_sharding, so the next step is handed the layout it was
    compiled for (left to GSPMD, the returned state comes back in another
    layout and the second step compiles again)."""
    return jax.tree.map(lambda x: jax.lax.with_sharding_constraint(
        x, channel_sharding(x, mesh, axis)), tree)


def sharded_pipeline_step(pipeline, mesh: Mesh, axis=None):
    """Compile the pipeline step with channel-sharded inputs/outputs.

    Returns (step_fn, shard_fn): ``shard_fn`` places state/iq onto the mesh;
    ``step_fn(state, iq)`` is the SPMD-compiled block step. ``axis``
    defaults to the mesh's channel axes (the ('host','chip') product on a
    2-D mesh).
    """
    if axis is None:
        axis = mesh_channel_axes(mesh)

    def step(state, iq_i, iq_q):
        state, out = pipeline._step_impl(state, iq_i, iq_q)
        return constrain_channels(state, mesh, axis), out

    # shardings are inferred from the annotated inputs; outputs follow
    step_fn = jax.jit(step)

    def shard_fn(tree):
        return shard_channels(tree, mesh, axis)

    return step_fn, shard_fn


def time_parallel_fir(x: jax.Array, taps: jax.Array, mesh: Mesh,
                      axis: str = "chip") -> jax.Array:
    """FIR over a stream whose TIME axis is sharded across devices.

    x: [channels, n] with n divisible by mesh.shape[axis]. Each device
    filters its time block after receiving the ``ntaps-1``-sample halo from
    its left neighbor via ppermute (device 0 uses zero initial state).
    Result equals the unsharded causal FIR exactly.
    """
    taps = jnp.asarray(taps)
    ntaps = taps.shape[0]
    ndev = mesh.shape[axis]
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]

    def local(x_blk):
        tail = x_blk[:, -(ntaps - 1):]
        halo = jax.lax.ppermute(tail, axis, perm)
        idx = jax.lax.axis_index(axis)
        halo = jnp.where(idx == 0, jnp.zeros_like(halo), halo)
        xp = jnp.concatenate([halo, x_blk], axis=-1)
        return _apply_windows(xp, taps)

    fn = shard_map(local, mesh=mesh,
                   in_specs=P(None, axis), out_specs=P(None, axis))
    return fn(x)


def frontend_serial(iq_i: jax.Array, iq_q: jax.Array, chan_taps, match_taps,
                    decim: int = 1, scale: float = 1.0,
                    dc_block: bool = True) -> jax.Array:
    """Single-device reference of the pipeline's jnp front end with zero
    initial state: channel filter (stride ``decim``) -> FM quadrature
    discriminator -> optional DC block -> matched FIR. The oracle for
    :func:`time_parallel_frontend`."""
    chan_taps = jnp.asarray(chan_taps)
    match_taps = jnp.asarray(match_taps)
    nt_c, nt_m = chan_taps.shape[0], match_taps.shape[0]
    c = iq_i.shape[0]
    z = jnp.zeros((c, nt_c - 1), iq_i.dtype)
    cfi = _apply_windows(jnp.concatenate([z, iq_i], -1), chan_taps, stride=decim)
    cfq = _apply_windows(jnp.concatenate([z, iq_q], -1), chan_taps, stride=decim)
    z1 = jnp.zeros((c, 1), cfi.dtype)
    pi_ = jnp.concatenate([z1, cfi[:, :-1]], -1)
    pq_ = jnp.concatenate([z1, cfq[:, :-1]], -1)
    dre = cfi * pi_ + cfq * pq_
    dim = cfq * pi_ - cfi * pq_
    audio = jnp.arctan2(dim, dre) * scale
    if dc_block:
        audio = audio - jnp.mean(audio, axis=-1, keepdims=True)
    zm = jnp.zeros((c, nt_m - 1), audio.dtype)
    return _apply_windows(jnp.concatenate([zm, audio], -1), match_taps)


def time_parallel_frontend(iq_i: jax.Array, iq_q: jax.Array, chan_taps,
                           match_taps, mesh: Mesh, decim: int = 1,
                           scale: float = 1.0, dc_block: bool = True,
                           axis: str = "chip") -> jax.Array:
    """The FULL demod front end over a TIME-sharded block (SURVEY.md §5.7).

    One IQ block [C, n] has its time axis split across the mesh; each
    device receives a single left halo of

        H = decim * nt_match + nt_chan - 1

    full-rate samples from its neighbor via ``ppermute`` and RECOMPUTES the
    chain inside the halo (channel filter + decimate + FM discriminator +
    matched FIR) — one collective for three dependent stages, the same
    recompute-in-halo strategy as the fused Pallas kernel's intra-block
    chunks (pallas/frontend.py). The DC block becomes a ``pmean`` over the
    time axis. Output [C, n // decim] equals :func:`frontend_serial`
    exactly; device 0 uses zero history (a fresh stream).

    This is the framework's context-parallel demonstration beyond a single
    FIR: the whole memory-bound front end scales over devices when one
    block's time span (not the channel count) is the large axis.
    """
    chan_taps = jnp.asarray(chan_taps)
    match_taps = jnp.asarray(match_taps)
    nt_c, nt_m = chan_taps.shape[0], match_taps.shape[0]
    ndev = mesh.shape[axis]
    c, n = iq_i.shape
    n_loc = n // ndev
    if n % ndev or n_loc % decim:
        raise ValueError(f"n={n} must split into {ndev} blocks divisible "
                         f"by decim={decim}")
    H = decim * nt_m + nt_c - 1
    if H > n_loc:
        raise ValueError(f"halo {H} exceeds local block {n_loc}")
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]

    def local(xi, xq):
        def with_halo(x):
            h = jax.lax.ppermute(x[:, -H:], axis, perm)
            idx = jax.lax.axis_index(axis)
            h = jnp.where(idx == 0, jnp.zeros_like(h), h)
            return jnp.concatenate([h, x], axis=-1)

        # chanfilt over [C, H + n_loc]: nt_m extra (history) outputs lead
        # the local segment ((H - nt_c + 1)/decim == nt_m by construction)
        cfi = _apply_windows(with_halo(xi), chan_taps, stride=decim)
        cfq = _apply_windows(with_halo(xq), chan_taps, stride=decim)
        pi_, pq_ = cfi[:, :-1], cfq[:, :-1]
        ci, cq = cfi[:, 1:], cfq[:, 1:]
        dre = ci * pi_ + cq * pq_
        dim = cq * pi_ - ci * pq_
        audio = jnp.arctan2(dim, dre) * scale   # [C, nt_m - 1 + n_loc/decim]
        if dc_block:
            dc = jax.lax.pmean(
                jnp.mean(audio[:, nt_m - 1:], axis=-1, keepdims=True), axis)
            audio = audio - dc
            # device 0's history is the serial path's literal zero initial
            # state — keep it zero rather than dc-subtracted
            idx = jax.lax.axis_index(axis)
            hist = jnp.arange(audio.shape[-1]) < nt_m - 1
            audio = jnp.where((idx == 0) & hist[None, :], 0.0, audio)
        return _apply_windows(audio, match_taps)  # [C, n_loc / decim]

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(None, axis), P(None, axis)),
                   out_specs=P(None, axis))
    return fn(iq_i, iq_q)
