r"""Visualization: mesh overlays (software/pyrender) and keypoint drawing."""

from .render import Renderer, SoftwareRenderer  # noqa: F401
from .keypoints import (draw_keypoints, view_2d_keypoint,  # noqa: F401
                        view_2d_keypoint_on_z_1)
from .viewers import (Button, Slider,  # noqa: F401
                      RotationViewer, BulletMotionViewer,
                      StreamingDataViewer)
