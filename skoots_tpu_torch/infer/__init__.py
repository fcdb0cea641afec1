"""Inference of the port (``skoots_tpu/infer``): ``run_inference`` (the
engines behind ``skoots --image``), the whole-volume device pipelines and
the sharded pipeline over a device mesh."""

from skoots_tpu_torch.infer.device_pipeline import (
    make_chunked_pipeline,
    make_device_pipeline,
    segment_volume_chunked,
)
from skoots_tpu_torch.infer.engine import run_inference
from skoots_tpu_torch.infer.sharded import (
    make_sharded_assign,
    make_sharded_forward,
    make_sharded_pipeline,
    shard_volume,
)

__all__ = [
    "run_inference",
    "make_device_pipeline",
    "make_chunked_pipeline",
    "segment_volume_chunked",
    "make_sharded_forward",
    "make_sharded_assign",
    "make_sharded_pipeline",
    "shard_volume",
]
