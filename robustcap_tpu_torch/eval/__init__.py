r"""Offline evaluation: dataset sequences, the batched runner, the metric
suite and the serving modes' quality contract."""

from .evaluator import (  # noqa: F401
    BinaryConfusionMatrixEvaluator, BinaryClassificationErrorEvaluator,
    PositionErrorEvaluator, RotationErrorEvaluator, PerJointErrorEvaluator,
    MeanPerJointErrorEvaluator, MeshErrorEvaluator, FullMotionEvaluator)
from .datasets import (  # noqa: F401
    EvalSequence, build_aist_sequences, build_tc_sequences,
    build_pw3d_sequences, bucket_sequences, load_torch_file)
from .runner import run_sequences, stack_frames  # noqa: F401
from .evaluate import (  # noqa: F401
    cal_mpjpe, evaluate_aist_ours, evaluate_tc_ours, evaluate_pw3d_ours,
    evaluate_sequences)
from .visualize import (run_single_view, view_aist,  # noqa: F401
                        view_aist_unity)
from .contacts import (contact_labels_from_joints,  # noqa: F401
                       evaluate_contacts)
from .quality import END_METRIC_BOUND_MM, serve_end_metric_deltas  # noqa: F401
