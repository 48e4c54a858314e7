"""Camera poses and ray generation."""

from keras_nerf_tpu_torch.data.rays import (
    camera_plane_directions,
    generate_ray_batch,
    generate_rays,
)
from keras_nerf_tpu_torch.data.utils import get_focal_from_fov, pose_spherical

__all__ = ["camera_plane_directions", "generate_ray_batch", "generate_rays",
           "get_focal_from_fov", "pose_spherical"]
