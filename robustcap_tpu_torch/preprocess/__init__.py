r"""Sensor synthesis and the synthetic fixture corpora the evaluation runs
on (port of part of ``robustcap_tpu/preprocess``)."""

from .synthesis import (normalize_keypoints, project_points,  # noqa: F401
                        syn_acc, sync_3d_mp, synthesize_imu)
from .fixtures import (build_fixture_dataset,  # noqa: F401
                       build_fixture_dataset_pw3d, smooth_random_motion)
