"""Device operators of the port: each kernel's wrapper beside its plain
PyTorch form.

* ``predict``  -- K1 synthesis (CUDA, ``csrc/synth.cu``);
* ``entropy``  -- K2 stream Rice decode (CUDA, ``csrc/entropy.cu``);
* ``crc``      -- K4 range CRC-16 (CUDA, ``csrc/crc.cu``);
* ``epilogue`` -- K3 wasted bits + stereo decorrelation (torch ops).

A wrapper takes its plain form only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""
