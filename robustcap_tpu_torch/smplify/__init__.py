r"""SMPLify kinematic refinement: pose priors, the fitting objective and the
batched L-BFGS runner."""

from .prior import MaxMixturePrior, angle_prior, l2_prior  # noqa: F401
from .losses import (gmof, temporal_body_fitting_loss,  # noqa: F401
                     temporal_ori_tran_fitting_loss)
from .runner import (TemporalSMPLify, smplify_runner,  # noqa: F401
                     make_smplify_fit, refine_sequences_batched)
