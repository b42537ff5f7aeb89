"""Training subsystem: data generation, losses, training loop, config,
seed selection; the JAX package's exports."""

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
    load_snapshots_h5,
    sample_training_batch,
    save_snapshots_h5,
)
from pde_superresolution_torch.training.losses import (  # noqa: F401
    LossNorms,
    LossWeights,
    compute_loss,
    compute_loss_norms,
)
from pde_superresolution_torch.training.loop import TrainState, train  # noqa: F401
from pde_superresolution_torch.training.selection import (  # noqa: F401
    SelectionResult,
    protocol_score,
    select_checkpoint,
)
