"""Symbol timing recovery, frame synchronization, and line coding.

Accelerator-native re-design of sondedump's shared decode machinery (SURVEY.md S0):
Gardner timing recovery is provided as a per-channel scan (classic,
sequential-in-time) while the production path uses the feed-forward
Oerder-Meyr estimator which vectorizes fully; the frame-sync correlator and
Manchester/biphase/descrambling stages are batched array ops.
"""

from sondetpu.sync.timing import (
    TimingState,
    timing_init,
    oerder_meyr_tau,
    symbol_sample,
    gardner_scan,
)
from sondetpu.sync.coding import (
    manchester_decode,
    biphase_m_decode,
    nrzs_decode,
    bits_to_bytes,
    bytes_to_bits,
    descramble_xor,
)
from sondetpu.sync.correlator import (
    correlate_syncword,
    find_frame_starts,
    gather_frames,
    syncword_to_chips,
)

__all__ = [
    "TimingState", "timing_init", "oerder_meyr_tau", "symbol_sample",
    "gardner_scan",
    "manchester_decode", "biphase_m_decode", "nrzs_decode",
    "bits_to_bytes", "bytes_to_bits", "descramble_xor",
    "correlate_syncword", "find_frame_starts", "gather_frames",
    "syncword_to_chips",
]
