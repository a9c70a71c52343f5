"""Device-side Reed-Solomon syndrome check as a GF(2) matmul.

The decode-stage device step of BASELINE.json:5. GF(256) syndrome computation
S_i = sum_j c_j * alpha^{deg_j * (fcr + i)} is bit-linear in the received
bytes: multiplying a symbol by a CONSTANT field element is a linear map over
GF(2)^8. Expanding each received byte into its 8 bit-planes therefore turns
the entire syndrome computation into ONE binary matrix product

    syndrome_bits[r, 8*nroots] = codeword_bits[r, 8*n] @ W[8*n, 8*nroots]  (mod 2)

with W a constant 0/1 matrix baked from the field tables — one matmul
instead of the gather-per-symbol formulation a CPU uses (sondedump computes
syndromes with log/antilog table lookups). The pipeline uses it to classify every gathered frame as RS-clean or
suspect ON DEVICE, so the host skips FEC entirely for clean frames.

A frame is declared clean only when every syndrome of every interleaved
codeword is zero; a clean verdict is exact (zero syndromes <=> zero error
polynomial for correctable patterns; an undetected-miss needs the error
polynomial to be a codeword, probability ~2^-192, and the per-block CRC16
layer above still applies).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import jax.numpy as jnp

from sondetpu.fec.gf256 import GF256


def _mul_const_bits(gf: GF256, k: int) -> np.ndarray:
    """[8, 8] 0/1: bit b' of x contributes bit b of GF_mul(x, k)."""
    m = np.zeros((8, 8), np.float32)
    for bp in range(8):
        prod = int(gf.mul(1 << bp, k))
        for b in range(8):
            if (prod >> b) & 1:
                m[bp, b] = 1.0
    return m


@lru_cache(maxsize=8)
def syndrome_matrix(n: int, nroots: int, fcr: int = 0, prim: int = 0x11D
                    ) -> np.ndarray:
    """W [8*n, 8*nroots] float32 0/1: bit b' of symbol j contributes
    bit b of syndrome i iff W[8j+b', 8i+b] = 1.

    Symbol j has degree n-1-j (codeword laid out [data | parity], highest
    degree first — the same convention as fec.rs.ReedSolomon.decode)."""
    gf = GF256(prim)
    w = np.zeros((8 * n, 8 * nroots), dtype=np.float32)
    for j in range(n):
        deg = n - 1 - j
        for i in range(nroots):
            k = int(gf.exp[(deg * (fcr + i)) % 255])     # alpha^{deg*(fcr+i)}
            w[8 * j:8 * j + 8, 8 * i:8 * i + 8] = _mul_const_bits(gf, k)
    return w


@lru_cache(maxsize=8)
def frame_syndrome_matrix(frame_bytes: int, data_start: int, parity_start: int,
                          nroots: int, interleave: int, fcr: int = 0,
                          prim: int = 0x11D) -> np.ndarray:
    """W_full [8*frame_bytes, 8*nroots*interleave]: the interleaved-codeword
    layout baked into one frame-level matrix, so the device check is a single
    ``frame_bits @ W_full`` with NO strided byte extraction."""
    gf = GF256(prim)
    nrs = (frame_bytes - data_start) // interleave
    n = nrs + nroots
    w = np.zeros((8 * frame_bytes, 8 * nroots * interleave), dtype=np.float32)
    for i in range(interleave):
        for j in range(n):
            if j < nrs:
                b_idx = data_start + interleave * j + i
            else:
                b_idx = parity_start + nroots * i + (j - nrs)
            deg = n - 1 - j
            # every frame byte maps to exactly one codeword position, so
            # plain assignment (no GF(2) accumulation) is correct
            for r in range(nroots):
                k = int(gf.exp[(deg * (fcr + r)) % 255])
                col = 8 * (i * nroots + r)
                w[8 * b_idx:8 * b_idx + 8, col:col + 8] = _mul_const_bits(gf, k)
    return w


def rs_clean_flags(frames, rs_layout: dict):
    """frames [..., frame_bytes] uint8/int32 -> clean [...] bool.

    True iff every syndrome of every interleaved codeword is zero (the frame
    needs no RS correction). Pure jnp: the GF(2) product is a 0/1 float32
    matmul at the default precision; every product and partial sum is a
    small integer, exact in TF32 and bf16 alike, so the parity below is
    exact on any backend."""
    fb = frames.shape[-1]
    w = frame_syndrome_matrix(fb, rs_layout["data_start"],
                              rs_layout["parity_start"], rs_layout["nroots"],
                              rs_layout.get("interleave", 2),
                              rs_layout.get("fcr", 0),
                              rs_layout.get("prim", 0x11D))
    bits = ((frames.astype(jnp.int32)[..., None] >> jnp.arange(8)) & 1
            ).astype(jnp.float32)
    bits = bits.reshape(bits.shape[:-2] + (8 * fb,))     # [..., 8*fb]
    snd = bits @ jnp.asarray(w)                          # [..., 8*nroots*ilv]
    odd = jnp.bitwise_and(snd.astype(jnp.int32), 1)      # mod 2
    return (odd.sum(axis=-1) == 0)
