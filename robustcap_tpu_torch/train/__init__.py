r"""Training: the generic loop, the data pipeline, features, losses and the
per-RNN trainers (port of ``robustcap_tpu/train``)."""

from .data import SeqDataset, padded_batches  # noqa: F401
from .loop import (train, save_pytree, load_pytree,  # noqa: F401
                   batch_inference, save_checkpoint, load_checkpoint)
from .losses import (masked_mse, masked_distance,  # noqa: F401
                     velocity_horizon_loss, make_fk_pose_loss,
                     masked_bce_pos_weight)
from .trainers import (train_rnn2, train_rnn3, train_rnn4,  # noqa: F401
                       train_rnn6, train_rnn7, train_rnn8, train_all,
                       merge_weights, make_forward_fn)
from . import features  # noqa: F401
