from rtgs_tpu_torch.viewer.orbit import (OrbitState, orbit_camera_pose,
                                         update_cursor)

__all__ = ["OrbitState", "orbit_camera_pose", "update_cursor"]
