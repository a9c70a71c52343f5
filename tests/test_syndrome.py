"""Device-side RS syndrome classification (fec/syndrome.py).

The GF(2)-matmul syndrome check must agree exactly with the host RS
decoder's notion of "no errors": clean <=> all syndromes zero."""

import numpy as np
import jax.numpy as jnp
import pytest

from sondetpu.fec.syndrome import rs_clean_flags, syndrome_matrix
from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth, SPEC

RS_LAYOUT = SPEC.extra["rs"]


def _frames(n=6):
    mod = RS41Modulator()
    return np.stack([mod.build_frame(RS41Truth(frame_no=i)) for i in range(n)])


def test_clean_frames_flagged_clean():
    frames = _frames()
    clean = np.asarray(rs_clean_flags(jnp.asarray(frames), RS_LAYOUT))
    assert clean.all()


def test_corrupted_frames_flagged_dirty():
    frames = _frames()
    rng = np.random.default_rng(0)
    dirty_rows = [1, 3, 4]
    for r in dirty_rows:
        # corrupt a single RS-protected byte (data region) — syndromes of one
        # codeword become nonzero
        pos = int(rng.integers(0x38, frames.shape[1]))
        frames[r, pos] ^= int(rng.integers(1, 256))
    clean = np.asarray(rs_clean_flags(jnp.asarray(frames), RS_LAYOUT))
    want = np.ones(frames.shape[0], bool)
    want[dirty_rows] = False
    np.testing.assert_array_equal(clean, want)


def test_parity_byte_corruption_detected():
    frames = _frames(3)
    frames[0, 8] ^= 0x40          # parity region byte of codeword 0
    frames[2, 8 + 24] ^= 0x01     # parity region byte of codeword 1
    clean = np.asarray(rs_clean_flags(jnp.asarray(frames), RS_LAYOUT))
    np.testing.assert_array_equal(clean, [False, True, False])


def test_channel_slot_shape_matches_flat():
    """The pipeline calls rs_clean_flags on [C, K, frame_bytes]; the
    verdicts must equal the flat [C*K, frame_bytes] call row for row."""
    frames = _frames(8)
    rng = np.random.default_rng(5)
    for r in (0, 2, 5):
        frames[r, int(rng.integers(0x38, 320))] ^= int(rng.integers(1, 256))
    want = np.asarray(rs_clean_flags(jnp.asarray(frames), RS_LAYOUT))
    np.testing.assert_array_equal(want, [r not in (0, 2, 5)
                                         for r in range(8)])
    got = np.asarray(rs_clean_flags(jnp.asarray(frames.reshape(2, 4, -1)),
                                    RS_LAYOUT))
    np.testing.assert_array_equal(got, want.reshape(2, 4))


def test_syndrome_matrix_matches_table_syndromes():
    """W reproduces the host decoder's table-driven syndromes bit for bit."""
    from sondetpu.fec.gf256 import GF256
    from sondetpu.fec.rs import ReedSolomon

    rs = ReedSolomon(nroots=24)
    gf = GF256()
    rng = np.random.default_rng(7)
    cw = rng.integers(0, 256, size=(5, 156), dtype=np.uint8)
    n = 156
    w = syndrome_matrix(n, 24)
    bits = ((cw[..., None].astype(np.int32) >> np.arange(8)) & 1
            ).reshape(5, 8 * n).astype(np.float32)
    snd_bits = (bits @ w).astype(np.int64) & 1
    got = (snd_bits.reshape(5, 24, 8) << np.arange(8)).sum(-1)
    # reference syndromes
    deg = np.arange(n - 1, -1, -1)
    want = np.zeros((5, 24), np.int64)
    for i in range(24):
        term = np.where(cw != 0, gf.exp[(gf.log[cw.astype(np.int32)]
                                         + deg[None, :] * i) % 255], 0)
        want[:, i] = np.bitwise_xor.reduce(term, axis=1)
    np.testing.assert_array_equal(got, want)


def test_decoder_rs_clean_fast_path_equivalent():
    """RS41Decoder with device clean flags produces identical fragments to
    the full host-RS path, including corrupted (dirty) frames."""
    from sondetpu.sondes.rs41 import RS41Decoder

    frames = _frames(6)
    rng = np.random.default_rng(3)
    for r in (1, 4):
        pos = rng.choice(np.arange(0x38, 320), size=6, replace=False)
        frames[r, pos] ^= rng.integers(1, 256, size=6).astype(np.uint8)
    clean = np.asarray(rs_clean_flags(jnp.asarray(frames), RS_LAYOUT))
    assert not clean[1] and not clean[4] and clean[0]
    chans = np.arange(6)

    d1 = RS41Decoder()
    frags_fast = d1.decode_byte_frames(frames, chans, rs_clean=clean)
    d2 = RS41Decoder()
    frags_full = d2.decode_byte_frames(frames, chans)
    assert len(frags_fast) == len(frags_full) == 6
    from dataclasses import asdict
    for (c1, f1), (c2, f2) in zip(frags_fast, frags_full):
        assert c1 == c2
        d1f, d2f = asdict(f1), asdict(f2)
        for k in d1f:
            v1, v2 = d1f[k], d2f[k]
            if isinstance(v1, float) and np.isnan(v1):
                assert np.isnan(v2), k
            else:
                assert v1 == v2, k
