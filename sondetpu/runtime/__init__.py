"""Runtime: jitted per-block pipelines, carry-over state, host stream driver.

The accelerator-native replacement for the reference's threaded block runtime
(SURVEY.md C1/C2: dsp::stream + dsp::block worker threads): one compiled
device program advances every channel by one IQ block; all inter-block
state (filter tails, demod phase, symbol clock, chip ring buffers) is an
explicit pytree threaded through the step function.
"""

from sondetpu.runtime.pipeline import Pipeline, PipelineConfig

__all__ = ["Pipeline", "PipelineConfig"]
