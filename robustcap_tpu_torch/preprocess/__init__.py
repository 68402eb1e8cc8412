r"""Dataset preprocessing (port of ``robustcap_tpu/preprocess``): sensor
synthesis, the fixture corpora, the raw-corpus drivers that write the work
dicts training and evaluation read, detector crops and occlusion."""

from .synthesis import (  # noqa: F401
    syn_acc, synthesize_imu, sync_3d_mp, project_points, normalize_keypoints,
    random_camera, synthesize_confidence)
from .fixtures import (build_fixture_dataset,  # noqa: F401
                       build_fixture_dataset_pw3d, smooth_random_motion)
from .datasets import (resample_sequence, interpolate_keypoints,  # noqa: F401
                       amass_sequence_to_work, totalcapture_align_imus,
                       check_real_vs_synthetic_imu, preprocess_amass,
                       preprocess_3dpw_sequence)
from .occlusion import (paste_over, occlude_with_objects,  # noqa: F401
                        resize_by_factor, load_occluders, random_occluders)
from .smooth_bbox import (kp_to_bbox_param, get_smooth_bbox_params,  # noqa: F401
                          get_all_bbox_params, smooth_bbox_params,
                          pw3d_crop_windows, get_bbox)
from .detectors import (detect_sequence, detect_sequence_cropped,  # noqa: F401
                        detect_sequence_occluded)
from .aist import (aist_camera_params, aist_sequence_to_work,  # noqa: F401
                   compute_not_aligned, repair_frame_count)
from .corpus import (splice_repair, fill_missing_frames,  # noqa: F401
                     preprocess_aist, write_not_aligned,
                     preprocess_totalcapture_pre, preprocess_totalcapture,
                     preprocess_3dpw, parse_vicon_positions,
                     parse_calibration)
