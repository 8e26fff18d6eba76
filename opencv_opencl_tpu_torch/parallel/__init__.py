"""Multi-GPU sharding of the enhancement step over a (data, space) mesh on
``torch.distributed`` (counterpart of ``opencv_opencl_tpu.parallel``)."""

from opencv_opencl_tpu_torch.parallel.mesh import best_mesh_shape, make_mesh
from opencv_opencl_tpu_torch.parallel.sharded import (
    build_sharded_pipeline,
    sharded_clahe,
    sharded_histeq,
)

__all__ = [
    "best_mesh_shape",
    "make_mesh",
    "build_sharded_pipeline",
    "sharded_clahe",
    "sharded_histeq",
]
