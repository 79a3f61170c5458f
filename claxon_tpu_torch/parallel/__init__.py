"""Lane sharding over several devices (counterpart of
``claxon_tpu.parallel``).

FLAC frames are independent: each carries its own header, CRC and
warm-up samples. So a decode bucket's lane axis (one (frame, channel)
subframe a lane) splits over devices as pure data parallelism. A
``mesh.Mesh`` is an ordered list of ``torch.device``; a bucket of L
lanes, padded to :func:`lane_quantum` (a multiple of 128 and of twice
the mesh size), splits into ``mesh.size`` equal, even, contiguous lane
ranges, shard i on ``mesh.devices[i]``, so a stereo pair never splits.
Each shard uploads its own lane rows and runs the bucket's kernels on
its device. The stream upload (and on the segmented path the demux
outputs) is copied once to each distinct device; the frame CRC check
splits on frames. Nothing crosses between devices on the card, and the
decoded buckets stay where their shards ran
(``DeviceDecoded.device_buckets()`` hands back the shards in lane
order).
"""

from .mesh import (LANE_AXIS, decode_batch_sharded, decode_streams_sharded,
                   lane_quantum, make_decode_step, make_mesh)

__all__ = ["make_mesh", "make_decode_step", "decode_batch_sharded",
           "decode_streams_sharded", "lane_quantum", "LANE_AXIS"]
