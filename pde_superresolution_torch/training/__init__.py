"""Training subsystem: data generation, losses, training loop, config.

The JAX package's exports, without its HDF5 interchange
(``save_snapshots_h5``/``load_snapshots_h5``). Seed selection is the
``selection`` submodule, as in the JAX package.
"""

from pde_superresolution_torch.training.config import (  # noqa: F401
    TrainingConfig,
    parse_hparams,
)
from pde_superresolution_torch.training.data import (  # noqa: F401
    Snapshots,
    TrainingData,
    TrajectoryData,
    build_training_data,
    build_trajectory_data,
    generate_snapshots,
    sample_training_batch,
)
from pde_superresolution_torch.training.losses import (  # noqa: F401
    LossNorms,
    LossWeights,
    compute_loss,
    compute_loss_norms,
)
from pde_superresolution_torch.training.loop import TrainState, train  # noqa: F401
