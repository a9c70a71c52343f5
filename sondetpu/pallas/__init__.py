"""Hand-written accelerator kernels.

One kernel remains: the fused dual-tone FSK front end
(:mod:`sondetpu.pallas.dualtone`, Pallas through Triton, compiled for a
GPU). The jnp path in runtime/pipeline.py is its reference and the default
everywhere else; tests run the kernel in the Pallas interpreter.
"""
