"""Device operators of the port: each kernel's wrapper beside its plain
PyTorch form.

* ``predict``  -- K1 synthesis, alone and with K3 fused into its store
  (CUDA, ``csrc/synth.cu``);
* ``entropy``  -- K2 stream Rice decode (CUDA, ``csrc/entropy.cu``);
* ``crc``      -- K4 range CRC-16 (CUDA, ``csrc/crc.cu``), and the CRC-16
  of byte-matrix rows, ``crc16_device``, and of right-aligned windows of
  the upload, ``crc16_frames_device`` (CUDA, ``csrc/crc_lanes.cu``; no
  decode route calls them);
* ``rice``     -- ``rice_decode``, one Rice partition a lane over a shared
  packed bit buffer (CUDA, ``csrc/rice.cu``; no decode route calls it);
* ``epilogue`` -- K3 wasted bits + stereo decorrelation (torch ops, the
  plain form of the fused kernel) and K3b int16-pair pack and unpack
  (CUDA, ``csrc/pack16.cu``);
* ``segment``  -- K5 sync scan and header CRC-8 (CUDA, ``csrc/segment.cu``;
  the decode path runs it inside the fused front);
* ``seg_parse`` -- K6 fused-demux body: the fused front (bswap, K5, header
  fields and compaction in two kernels) and the summary (CUDA,
  ``csrc/seg_parse.cu``), and the fused run;
* ``demux``    -- K7 subframe walk (CUDA, ``csrc/demux.cu``);
* ``seg_gather`` -- K8 values gather (CUDA, ``csrc/seg_gather.cu``).

A wrapper takes its plain form only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. The package exports the JAX
package's names but ``i64``, its 32-bit limb arithmetic, which CUDA's
int64 makes unneeded.
"""

from .crc import crc16_device
from .epilogue import apply_epilogue
from .predict import synthesize, synthesize_best, synthesize_reference
from .rice import rice_decode

__all__ = ["synthesize", "synthesize_best", "synthesize_reference",
           "apply_epilogue", "crc16_device", "rice_decode"]
