"""Batched DSP primitives: filtering, demodulation, resampling, channelization.

Accelerator-native replacements for the SDR++ core DSP blocks the reference wires up
(SURVEY.md §2.2: dsp::demod::FM, dsp::multirate::RationalResampler, VFO
channel extraction) plus the shared front-end of the sondedump decoders
(S0: matched filter, AGC). Everything operates on a batch/channel axis so
one compiled program serves thousands of concurrent channels.
"""

from sondetpu.dsp.fir import (
    design_lowpass,
    gaussian_taps,
    fir_filter,
    FIRState,
    fir_init,
    fir_apply,
)
from sondetpu.dsp.demod import fm_demod, FMState, fm_init, fm_apply, afsk_discriminate
from sondetpu.dsp.resample import polyphase_decimate, rational_resample

__all__ = [
    "design_lowpass",
    "gaussian_taps",
    "fir_filter",
    "FIRState",
    "fir_init",
    "fir_apply",
    "fm_demod",
    "FMState",
    "fm_init",
    "fm_apply",
    "afsk_discriminate",
    "polyphase_decimate",
    "rational_resample",
]
