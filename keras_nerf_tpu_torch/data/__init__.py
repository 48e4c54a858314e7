"""Scene data: Blender datasets, camera poses, ray generation and the
synthetic scene fixture."""

from keras_nerf_tpu_torch.data.loader import (
    DatasetLoader,
    NeRFDataset,
    RayBatchDataset,
)
from keras_nerf_tpu_torch.data.rays import (
    camera_plane_directions,
    generate_ray_batch,
    generate_rays,
    sample_random_ray_batch,
)
from keras_nerf_tpu_torch.data.utils import get_focal_from_fov, pose_spherical

__all__ = ["DatasetLoader", "NeRFDataset", "RayBatchDataset",
           "camera_plane_directions", "generate_ray_batch", "generate_rays",
           "get_focal_from_fov", "pose_spherical", "sample_random_ray_batch"]
