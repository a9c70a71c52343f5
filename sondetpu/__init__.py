"""sondetpu — an accelerator-native radiosonde decoding framework.

A from-scratch re-design of the capabilities of the SDR++ radiosonde decoder
plugin (dbdexter-dev/sdrpp_radiosonde) as a massively channel-parallel JAX/XLA
pipeline: wideband IQ is channelized, FM/AFSK-demodulated, symbol-timed,
frame-synced, FEC-decoded and parsed into telemetry for thousands of
concurrent sonde channels on accelerator device meshes.

Layer map (vs. reference /root/reference, see SURVEY.md):
  L2 channelization/demod  -> sondetpu.dsp      (ref: SDR++ core VFO/FM/resampler)
  L4 signal decode         -> sondetpu.sync, sondetpu.fec, sondetpu.sondes
                              (ref: sondedump C library)
  L3/L5 adapter+aggregation-> sondetpu.telemetry, sondetpu.runtime
                              (ref: src/decode/decoder.hpp)
  L6 sinks                 -> sondetpu.io        (ref: src/gpx.cpp, src/ptu.cpp)
  L7 config                -> sondetpu.cli.config (ref: ConfigManager use in src/main.cpp)
  parallel scale-out       -> sondetpu.parallel  (no reference analogue; BASELINE.json:5)
"""

__version__ = "0.1.0"

from sondetpu.telemetry import SondeTelemetry, TelemetryFragment, Fields

__all__ = ["SondeTelemetry", "TelemetryFragment", "Fields", "__version__"]
